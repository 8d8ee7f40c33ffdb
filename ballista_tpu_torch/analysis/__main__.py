"""CLI: `python -m ballista_tpu_torch.analysis`.

Exit codes: 0 clean (or fully baselined/suppressed), 1 actionable findings
or stale baseline entries, 2 usage error.
"""

from __future__ import annotations

import argparse
import sys

from ballista_tpu_torch.analysis.core import Analyzer, save_baseline


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m ballista_tpu_torch.analysis",
        description="Run the engine invariant analyzer over the repo.",
    )
    ap.add_argument("--root", default=None, help="repo root (default: auto-detect)")
    ap.add_argument("--baseline", default=None,
                    help="baseline file (default: "
                         "ballista_tpu_torch/analysis/baseline.json); "
                         "pass an empty string to ignore the baseline")
    ap.add_argument("--json", action="store_true", help="machine-readable output")
    ap.add_argument("--update-baseline", action="store_true",
                    help="write all current findings to the baseline file and exit 0 "
                         "(each entry still needs a hand-written reason before review)")
    ap.add_argument("--pass", dest="passes", action="append", default=None,
                    metavar="PASS_ID", help="run only this pass (repeatable)")
    ap.add_argument("-v", "--verbose", action="store_true",
                    help="also list suppressed and baselined findings")
    args = ap.parse_args(argv)

    baseline = args.baseline
    analyzer = Analyzer(root=args.root,
                        baseline_path="/dev/null" if baseline == "" else baseline)
    report = analyzer.run(pass_ids=args.passes)

    if args.update_baseline:
        combined = report.findings + [f for f, _ in report.baselined]
        reasons = {f.key(): r for f, r in report.baselined}
        save_baseline(analyzer.baseline_path, combined, reasons)
        print(f"wrote {len(combined)} entr(ies) to {analyzer.baseline_path}")
        return 0

    try:
        if args.json:
            print(report.to_json())
        else:
            print(report.render())
            if args.verbose:
                for f, sup in report.suppressed:
                    print(f"(suppressed: {sup.reason}) {f.render()}")
                for f, reason in report.baselined:
                    print(f"(baselined: {reason}) {f.render()}")
    except BrokenPipeError:  # e.g. piped into `head`
        pass
    return 0 if report.ok else 1


if __name__ == "__main__":
    sys.exit(main())
