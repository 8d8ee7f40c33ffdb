"""Typed string ids.

The reference macro-generates newtype ids (`JobId`, `JobName`,
ballista/core/src/ids.rs:59,118) so a job id can never be passed where a
stage key is expected. Python's analog: tiny str subclasses (zero-cost at
runtime, checkable by type checkers and by `isinstance` asserts in tests)
plus the id-minting helpers the scheduler uses.
"""

from __future__ import annotations

import random
import string
import time

_ALPHANUM = string.ascii_lowercase + string.digits


class JobId(str):
    __slots__ = ()


class JobName(str):
    __slots__ = ()


class ExecutorId(str):
    __slots__ = ()


class SessionId(str):
    __slots__ = ()


def new_job_id(rng: random.Random | None = None) -> JobId:
    """Sortable-ish unique job id: time prefix + random suffix.

    The reference uses a purely random 7-char id; we prefix a time component
    so `ls` of the shuffle work dir sorts by submission order, which the
    reference's own docs note is useful when debugging work-dir leaks.
    """
    r = rng or random
    t = int(time.time()) % (36**4)
    prefix = _b36(t, 4)
    suffix = "".join(r.choice(_ALPHANUM) for _ in range(6))
    return JobId(prefix + suffix)


def new_session_id(rng: random.Random | None = None) -> SessionId:
    r = rng or random
    return SessionId("".join(r.choice(_ALPHANUM) for _ in range(16)))


def new_executor_id(rng: random.Random | None = None) -> ExecutorId:
    r = rng or random
    return ExecutorId("".join(r.choice(_ALPHANUM) for _ in range(12)))


def _b36(n: int, width: int) -> str:
    digits = "0123456789abcdefghijklmnopqrstuvwxyz"
    out = []
    for _ in range(width):
        out.append(digits[n % 36])
        n //= 36
    return "".join(reversed(out))
