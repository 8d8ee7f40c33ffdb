"""Local mode: the port's executor engine embedded in the client process.

`SessionContext(BallistaConfig(settings))` with the configuration's
settings (`ballista.executor.engine=tpu`), every table registered as the
parquet directory the data step wrote. A statement is
`ctx.sql(text)` (parse and logical plan) and then `.collect()` (physical
plan, the device stages, the final stage, Arrow out).
"""

from __future__ import annotations

import os

from portbench.harness.program import program_counters


class Session:
    def __init__(self, ctx):
        self.ctx = ctx

    def sql(self, text: str):
        return self.ctx.sql(text)

    def collect(self, df):
        return df.collect()

    def counters(self) -> dict:
        return program_counters()

    def close(self) -> None:
        self.ctx = None


def open_session(config: dict, data_dir: str, tables: list[str]) -> Session:
    from ballista_tpu_torch.client.context import SessionContext
    from ballista_tpu_torch.config import BallistaConfig
    from ballista_tpu_torch.plan.provider import ParquetTable

    ctx = SessionContext(BallistaConfig(dict(config["settings"])))
    for t in tables:
        ctx.register_table(t, ParquetTable(os.path.join(data_dir, t)))
    return Session(ctx)
