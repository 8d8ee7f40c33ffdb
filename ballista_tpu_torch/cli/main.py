"""Interactive SQL REPL (rebuild of ballista-cli).

Run against a standalone in-process cluster or a remote scheduler:

    python -m ballista_tpu_torch.cli                      # standalone
    python -m ballista_tpu_torch.cli --host HOST --port N # remote

The device engine is the default (--engine tpu): its stages run on the
CUDA card, or on the CPU in their plain forms when the environment sets
BALLISTA_TORCH_PLATFORM=cpu; without either a device stage raises.
--engine cpu runs the CPU engine.

Dot-commands (ballista-cli/src/command.rs):
  .help | .tables | .schema <table> | .timing on|off | .quit
  CREATE EXTERNAL TABLE t STORED AS PARQUET LOCATION 'path';
  EXPLAIN [ANALYZE] <query>;  SET key = value;
"""

from __future__ import annotations

import argparse
import sys
import time

from ballista_tpu_torch.config import BallistaConfig
from ballista_tpu_torch.version import BALLISTA_VERSION


def format_table(tbl, max_rows: int = 100) -> str:
    if tbl.num_rows == 0:
        return "(0 rows)"
    df = tbl.slice(0, max_rows).to_pandas()
    body = df.to_string(index=False)
    suffix = f"\n({tbl.num_rows} rows)" if tbl.num_rows > max_rows else f"\n({tbl.num_rows} rows)"
    return body + suffix


class Repl:
    def __init__(self, ctx, timing: bool = True):
        self.ctx = ctx
        self.timing = timing

    def run_command(self, line: str) -> bool:
        """Returns False to exit."""
        cmd = line.strip()
        if not cmd:
            return True
        if cmd in (".quit", ".exit", "\\q"):
            return False
        if cmd == ".help":
            print(__doc__)
            return True
        if cmd == ".tables":
            for t in self.ctx.catalog.names():
                print(t)
            return True
        if cmd.startswith(".schema"):
            name = cmd.split(None, 1)[1] if " " in cmd else ""
            p = self.ctx.catalog.get(name)
            if p is None:
                print(f"table not found: {name}")
            else:
                for f in p.arrow_schema():
                    print(f"  {f.name}: {f.type}")
            return True
        if cmd.startswith(".timing"):
            self.timing = "on" in cmd
            print(f"timing {'on' if self.timing else 'off'}")
            return True
        try:
            t0 = time.time()
            out = self.ctx.sql(cmd).collect()
            elapsed = time.time() - t0
            print(format_table(out))
            if self.timing:
                print(f"Elapsed {elapsed:.3f} seconds.")
        except Exception as e:  # noqa: BLE001
            print(f"Error: {e}", file=sys.stderr)
        return True

    def loop(self) -> None:
        print(f"ballista_tpu_torch CLI v{BALLISTA_VERSION} — .help for help, .quit to exit")
        buf: list[str] = []
        while True:
            try:
                prompt = "ballista> " if not buf else "      ..> "
                line = input(prompt)
            except (EOFError, KeyboardInterrupt):
                print()
                return
            if line.strip().startswith("."):
                if not self.run_command(line):
                    return
                continue
            buf.append(line)
            if line.rstrip().endswith(";"):
                stmt = "\n".join(buf)
                buf = []
                if not self.run_command(stmt):
                    return


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="ballista_tpu_torch SQL CLI")
    ap.add_argument("--host", default=None, help="scheduler host (remote mode)")
    ap.add_argument("--port", type=int, default=50050)
    ap.add_argument("--engine", choices=("cpu", "tpu"), default="tpu")
    ap.add_argument("--concurrency", type=int, default=4)
    ap.add_argument("-c", "--command", default=None, help="run one statement and exit")
    ap.add_argument("-f", "--file", default=None, help="run statements from a file")
    args = ap.parse_args(argv)

    from ballista_tpu_torch.client.context import SessionContext
    from ballista_tpu_torch.config import EXECUTOR_ENGINE

    cfg = BallistaConfig({EXECUTOR_ENGINE: args.engine})
    if args.host:
        ctx = SessionContext.remote(f"{args.host}:{args.port}", cfg)
    else:
        ctx = SessionContext.standalone(cfg, num_executors=1, vcores=args.concurrency)

    repl = Repl(ctx)
    if args.command:
        repl.run_command(args.command)
        return
    if args.file:
        with open(args.file) as f:
            for stmt in f.read().split(";"):
                if stmt.strip():
                    repl.run_command(stmt + ";")
        return
    repl.loop()


if __name__ == "__main__":
    main()
