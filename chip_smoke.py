#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (ballista_tpu_torch) on one NVIDIA card.

Run from the root of a checkout:  python3 chip_smoke.py

Phases, each fatal on failure (non-zero exit, no result line):
1. print the card's name and power limit (nvidia-smi);
2. build every CUDA kernel from ballista_tpu_torch/ops/cuda/csrc with nvcc
   for sm_90a (one nvcc per source, started together);
3. hold each kernel against its plain PyTorch version on the card at the
   main path's shapes, two runs bitwise identical, and time the kernel,
   its plain version and one library call with CUDA events:
   masked_group_reduce at q4's P=8, N=262144, G=8 and at G=1, 32, 33, 300
   and 4096, P=1, N no multiple of a block's span or below one chunk, every
   row masked out, NaN/inf rows and ids outside [0, G) (counts exact, sums
   within rtol 1e-4 / atol 1e-4, the JAX package's own kernel bound, NaN
   exactly where the plain form has it; timed at G=8 and G=4096, library
   call torch.bincount); hash_probe at q5's
   P=8, N=8388608, T=32, at q21's supplier join at SF1 (its stage's
   [8, 2^20], T=2^14, 10,000 keys present) and at SF10 (T=2^17, 100,000
   keys), at T=2^18 with 30% absent keys (the engine's cap), and on both
   sides of every regime boundary (T = 12288, S, 9/4 S and 8S, S one
   block's opt-in shared memory in entries), each in the regime
   hash_probe_regime picks, exact (library call torch.take); dict_filter
   at q12's P=8, N=2097152 with T = 8 (q12), 256 (q14's p_type), 4096,
   2^17 and 2^22, each with and without a mask, and on both sides of every
   regime boundary (T = 32, the opt-in shared bitmap's last entry) and of
   the shared bitmap's packing (16384) at a ragged [8, 262147], each in the regime dict_filter_regime picks, exact
   (library call torch.take); the q12, q14 and q19 runs print its launches
   by (P, N, T, regime, masked);
   segmented_sort at the window shape [1, 2^20], at [1, 2^18] and
   [4, 4096], with ties and padding sentinels, and at the edges (rows
   below the 2048-lane tile, an odd count of merge passes, P > 1, rows of
   sentinels only, ties everywhere), exact, at most 12 launches a call
   (library: two stable torch.sort passes); topk_select at [1, 2^20] with
   k = 1, 100, 1000 and 4096 (through the full sort) and ties at the cut,
   and at P=3 over random, descending, all-tie and all-sentinel rows of
   1 to 2^20 lanes with k = 1, 100, 1000, 1024, 3000, 4096, exact, timed
   at k=100 on the top-k stage's operands and on descending keys
   (library: torch.topk(largest=False) of the key, timing only);
   segmented_scan at [1, 2^20]: i64 sum and max with a boundary about
   every 15 lanes, f64 max and min over NaN/+-0/+-inf, a row with no
   boundary, a boundary on every lane, and P > 1, rows below the tile
   and one lane, bitwise, one kernel and one memset a call; f32/f64
   sums within rtol 1e-5 / 1e-12 of the segment's sum of |v| (library:
   unsegmented torch.cumsum / cummax);
4. generate TPC-H with the port's generator (SF10 for q1/q6/q5/q12, SF1
   for q4, seed 42; reused when a matching manifest exists) and run q1,
   q6, q5 (auto mode), q12 (ballista.tpu.fusion.mode=fused_pallas) and q4
   through SessionContext with engine=tpu on the card — one warm-up, best
   of 3 — checking each answer against the port's engine=cpu (ints, dates
   and strings exact; float columns, which the CPU engine sums in float64
   where the card sums exact int64 cents, within rtol 1e-9), that every
   device stage ran on the card with no CPU fallback, that the device
   stage holds the expected joins, that the kernels of each path were
   launched (q4: masked_group_reduce; q5: hash_probe at least twice per
   run; q12: dict_filter at least once per run), and that the fusion
   modes are the reference's (q4 fused_pallas; q1, q6 fused_xla; q5
   requests fused_pallas and reports fused_xla after the money gate; q12
   fused_xla); the launch counts are set to 0 just before each query and
   read just after; one more traced run per query gives the card's busy
   time, idle share and six largest device ops (torch.profiler, checked
   first against CUDA events on a copy of known size; "null" when
   unchecked);
5. run the sort family at the same scale with
   ballista.tpu.sort.pallas.max.rows=1048576, fusion mode auto: win_orders
   (row_number, rank, count and max over PARTITION BY o_custkey ORDER BY
   o_orderdate), topk_partsupp (ORDER BY ps_supplycost LIMIT 100) and
   sort_customer (ORDER BY c_nationkey, c_acctbal DESC) — one warm-up,
   best of 3, one traced run — checking each answer equal to the port's
   engine=cpu answer exactly, in row order; every TpuWindowStageExec /
   TpuSortStageExec on the card for each of its partitions with no
   fallback; fused_pallas chosen by auto mode; and the launches of every
   run: 32 segmented_sort + 80 segmented_scan, 8 topk_select, 16
   segmented_sort;
6. the sorted aggregation: q3 at --scale, q9, q10, q13 and q21 at
   --q4-scale (SORTED_QUERIES says why), auto mode but q21 under
   fused_pallas — one warm-up, best of 3, one traced run — each answer
   checked against the port's engine=cpu as in phase 4, every device
   stage on the card with no fallback, at least one partial stage of each
   run sorted, q9 holding a sorted-mode join build and q21 launching
   hash_probe in every run; the stages' group counts, capacities, live
   rows and sort times recorded; then q1 under
   ballista.tpu.fusion.mode=staged, byte-identical to fused_xla with its
   span times, and device shuffle routing: lineitem grouped by l_orderkey
   under a hand-built hash ShuffleWriterExec of 16 partitions, every
   written row hashing on the host (ops/hashing) to its own partition and
   the rows together equal to the engine=cpu answer (both at --q4-scale);
   then q21 at --scale under fused_pallas, cold and one warm run (cut
   from best of 3 for phase 11's room in the time limit), its
   answer equal to fused_xla's on the card exactly (rows and order), its
   supplier probe (T=2^17 at SF10) launching hash_probe in the regime
   hash_probe_regime picks in every run, with the (P, N, T, regime, C) of
   each launch recorded;
   phases 4-6 run with the host spill pool off, so an evicted table is
   dropped as before the pool existed;
7. out of core, with the spill pool on: (a) q3 with hbm_oom chaos armed
   (the first upload raises once) spills, retries once and answers as in
   phase 6 (floats within rtol 1e-9), its peak device memory recorded;
   (b) a real torch.cuda.OutOfMemoryError: q1's and q6's tables resident,
   one blocker tensor holding the card's free memory less a margin between
   (a)'s peak less the residents and a cold whole q3 run's peak, q3's
   first attempt runs out of memory, the spill of the residents makes room
   and the retry answers as in phase 6; (c) q1, q6,
   q1 under a budget that holds one of their tables: q6's fill spills q1's
   table to host buffers and the second q1 restores it with no encode,
   every plane's CRC-32 unchanged, answers equal to phase 4's exactly;
   then at --q4-scale, after q1, q5 and q12 ran there locally as in phase
   4: (d) q5 at its working set (the local run's admission reason) less 1
   byte: a grace split into 4 sub-buckets, one cold run, best of 3, one
   traced run, answers equal to the local run's device and CPU answers
   (revenue within rtol 1e-9), no fallback, hash_probe twice per sub-run;
   (e) q5 at a budget that needs 16 sub-buckets (depth 2),
   equal to its whole run, and (f) the round trip of (c) through the disk
   tier (host tier cut to 1 byte), leaving no .tmp file. Chaos is disarmed,
   the blocker freed and every cache cleared in `finally`;
8. the distributed standalone mode: q6 at --scale and q5 (auto mode),
   q12 (fused_pallas) and q4 at --q4-scale (q5 launching hash_probe,
   q12 dict_filter and q4 masked_group_reduce in every run) through
   SessionContext.standalone(num_executors=1, vcores=4) with engine=tpu:
   the in-process scheduler cuts stages at the shuffle boundaries, ships
   one task per partition, each executor hands its stage to the CUDA
   engine, and the stages exchange Arrow IPC shuffle files. A cold run and
   best of 3, each answer equal to the same query's local answer on the
   card at its scale (phase 4, 6 or 7; ints, dates, strings exact; floats
   within rtol 1e-9); every device stage on the card in every task with no
   fallback,
   one device pass per task, and every device node kind of the local run
   present; one traced warm run. Per query one JSON line: the walls, the
   stages and tasks per stage, device passes per stage beside local
   mode's, shuffle bytes written and read, Flight RPCs, kernel launches per
   run beside local mode's, busy time and idle share, peak device bytes and
   the admission plans. Then q3 once more over two executors with
   ballista.shuffle.reader.force_remote_read, every read over Flight, held
   to the same answer;
9. the remote mode, the tables dropped first: (a) an in-process scheduler
   daemon (SchedulerProcess on 127.0.0.1: gRPC, REST, the Flight result
   proxy) and one push ExecutorProcess at engine=tpu pinned to card 0 (one
   slot), over real sockets; q6 at --scale and q1, q5 (auto mode), q12
   (fused_pallas) and q4 at --q4-scale through SessionContext.remote(addr):
   a cold run, best of 3 (one warm run for q5 and q12 when the run is late,
   LATE_AT) and one traced warm run, held as in phase 8 (each
   answer equal to the local answer at its scale, every device stage on
   the card in every task with no fallback, one pass per task), q4 launching
   masked_group_reduce, q5 hash_probe and q12 dict_filter in every run;
   per query one JSON line as phase 8's plus the scheduler's gRPC launches
   and status updates per run; (b) a pull executor beside the push one, q3
   with ballista.shuffle.reader.force_remote_read, every read over Flight,
   held to phase 6's answer, with the data plane each executor served from
   (the native server of native/ or the Python one); (c) real daemons,
   `python -m ballista_tpu_torch.scheduler` and `python -m
   ballista_tpu_torch.executor --engine tpu --device-ordinal 0`: the
   executor registers with ordinal 0 and one slot (REST /api/executors),
   q6 and q4 answer as in phase 4 with every device stage on the card
   (the job's metrics over GetJobMetrics), the daemon builds no kernel
   again, nvidia-smi lists one CUDA context more than this process's while
   both daemons run and none more once the executor has gone (the
   scheduler still up), and SIGTERM drains the executor to exit 0 with
   none of its children (the native Flight server) left running;
10. TPC-DS from the port's generator (seed 17, 2 files a sales table, as
   tests/test_tpcds.py; under --tpcds-dir), QUERY_CONFIG, auto mode:
   (a) (run after phase 3, while TPC-H is generated) all 99 queries at
   scale 0.1 once each, each answer equal to the
   port's engine=cpu answer (as in phase 4, in row order; floats within
   rtol 1e-4 where a run launched masked_group_reduce, a float32 kernel
   as in the JAX package, F32_LANE_RTOL; q4, q11 and q74 too, which the
   JAX package cannot run on its device engine, ROADMAP C13), every device
   node claimed, run and fallen back as on the port's CPU form (engine=tpu
   after runtime.use_cpu(), computed in a worker), q64's final stages
   declined for C14's reason; one JSON line per query with its device
   nodes and kernel launches; (b) q36, q47, q67, q86, q98 (the sort and
   window shapes the JAX package pins) and q93 (C12) at generator scale
   10 (3,000,000 store_sales rows): a cold run (the warm-up), best of 3
   (one warm run when reached late, LATE_AT) and one traced run, each held
   as in (a), every sort or window stage that auto mode sends to
   fused_pallas launching its kernels in its run;
   per query the stages' fusion modes, reasons and padded lanes, the
   launches per run of the six kernels, busy time, idle share, the six
   largest device ops and the peak device bytes;
11. (run after phase 9, before 10 (b)) the warm device daemon at
   --q4-scale: (a) `python -m ballista_tpu_torch.device_daemon
   --device-ordinal 0` spawned after this process's caches are freed, its
   probe report's init phases (platform_probe, cuda_devices,
   first_launch), its budget and no kernel library built (it loads phase
   2's); (b) a fresh client process (this script with --daemon-client)
   runs q4, q5, q12 (fused_pallas) and q1 through it, a cold run and best
   of 3 warm each: every answer equal to the local one at that scale (phases 4
   and 6, as in phase 8), every routed stage attached, the daemon
   launching masked_group_reduce, hash_probe and dict_filter in each run
   of q4, q5 and q12 (its own counts, read from its status around each
   run), torch.cuda.is_initialized() false in the client at its end, and
   nvidia-smi listing one CUDA context more than this process's while the
   client runs, the daemon's and not the client's (by pid where it sees
   pids); (c) a second fresh client: the same checks, answers
   byte-identical to the first's, the daemon's tables hit and none filled,
   no kernel library built, and one traced run per query under the
   daemon's profiler (its device busy time); (e) that client's
   clear_device_caches() empties the daemon's resident tables; (d) this
   process attached with daemon_crash armed at mid_execute once: q4 is
   answered byte-identically after one respawn, daemon_restarts 1, the
   crashed daemon's exit 137, a new generation token; (f) SIGTERM: the
   respawned daemon exits 0 and its socket is gone. The clients' imports
   run while the daemon starts and the first client runs;
12. (run after 10 (b)) the serving surface, engine=tpu throughout: (a)
   q6, q4, q5 and q12 (fused_pallas, its ship modes as `=` predicates) at
   --q4-scale, each prepared once in local mode and through
   SessionContext.standalone(num_executors=1, vcores=4) and executed with
   A's, B's and A's literals: each answer equal to engine=cpu's answer of
   that text (as in phase 4; F32_LANE_RTOL where masked_group_reduce
   ran), every device stage on the card with no fallback, each
   execution's kernel launched (masked_group_reduce, hash_probe,
   dict_filter in both modes), per execution its wall, plan-cache and
   result-cache hits and device passes, and one traced warm execution;
   (b) two continuous queries over --q4-scale lineitem in the standalone
   mode with the result cache on, q1's grouping with its COUNT and q12 (a
   delta join): three lineitem deltas from the port's generator (scale
   0.01, seeds 43-45) appended, each push equal to engine=cpu over the base
   and the deltas so far, each refresh maintained, its incremental_mode,
   reason, device nodes and append-to-push time printed, the last one
   traced; (c) DirectDispatcher over LocalLeaseTransport on a standalone
   executor: three parameter sets direct, each equal to the graph path and
   engine=cpu, the lease revoked (demoted, equal), a fresh lease direct;
   (d) an in-process SchedulerProcess and one ExecutorProcess pinned to
   card 0 with the Python Flight server: q4 prepared with A and B, an
   append of 20,000 rows pushed to q1's count subscription, and two
   executions over FlightLeaseTransport, each equal to engine=cpu;
13. (run after 12) the SQL CLI, `python -m ballista_tpu_torch.cli --engine
   tpu -f FILE` as a process, at --q4-scale, phases 4-6's settings as SET
   statements: (a) remote (--host/--port) against an in-process
   SchedulerProcess and one ExecutorProcess pinned to card 0: CREATE
   EXTERNAL TABLE for q5's six tables, q4, q5, then SET
   ballista.tpu.fusion.mode = fused_pallas and q12, each run once; this
   process counts the executor's launches (masked_group_reduce, hash_probe
   at least twice, dict_filter); (b) the CLI's default standalone mode, q4
   and its EXPLAIN ANALYZE: every device node device_runs >= 1 and
   cpu_fallbacks=0; (c) over (a)'s scheduler REST, the TUI's RestClient
   and render layer draw one headless frame listing (a)'s jobs completed,
   with their stages. Each printed answer equal to the engine=cpu answer
   already held (ints and strings exact, floats within rtol 1e-9 as
   printed), no `Error:` line, exit 0; each statement's printed Elapsed
   and each process's wall recorded;
14. (run after 13) the mesh, at --q4-scale: (c) q1, q3, q4 and q13
   through SessionContext.standalone(num_executors=1, vcores=4) with
   ballista.tpu.mesh.enabled off, then on (a cold and a warm run): fewer
   stages, the merged stage one task with its producer on the card,
   mesh_mode_reason demoted:single-device (one visible card), answers
   byte-identical to the mesh-off run and equal to engine=cpu's, no shuffle
   files for the fused edge, q4's producer launching masked_group_reduce;
   (a) over Mesh([cuda:0] * 4), four shards of the card:
   hash_exchange_table on q13's and q4's producer output as (c)'s merged
   stages received it, hash_exchange_all_to_all on lineitem's l_orderkey
   and partial_then_psum on l_quantity, each equal to its CPU form bit
   for bit, every row on the shard its hash % 4 names in row order, timed
   with CUDA events; (b) MeshExchangeExec._device_exchange over the same
   shards on q3's (a date column) and q13's producers, byte-identical to
   the host split; (d) local q1 with ballista.tpu.collective.exchange on:
   no stage mesh on one card, the claims and answer of the run without
   it; (e) q1's partial-aggregate stage handed the 4-shard mesh: its table
   split by partition, every partition's output equal to the unsharded
   pass;
15. (run after 14) the cold path and the object store, at --q4-scale:
   (a) q5 (auto mode) and q21 (fused_pallas) cold, each after every cache
   is dropped, under ballista.tpu.compile.overlap off, on, and on with
   ballista.tpu.fill.chunk_rows 2^18: every answer byte-identical across
   the settings and equal to engine=cpu's, every device stage on the card
   with no fallback, hash_probe launched, with overlap on each join build
   in the card's scope on a thread of its own and off none; each run's
   cold wall, fill_s, upload_s, build_s and launches printed; (b) the
   --q4-scale directory served as an S3 bucket by the port's in-process
   shim (testing/mini_s3.py), orders and lineitem registered as s3://
   tables: q4 (masked_group_reduce) and q12 (fused_pallas, dict_filter)
   cold and 3 warm runs, each equal to the local-file run's answer and to
   engine=cpu's, every device stage on the card, the kernel launched in
   every run, the HEAD requests of each run's planning and execution;
   C26: an object rewritten with another size and registered again answers
   its new sums on the card; a UDF query (double_it) whose stage declines
   with its recorded reason and answers as engine=cpu; reached late
   (LATE_AT), overlap off and on only and q4 alone over S3. Phase 6 prints
   q21 large's build_s, its builds now beside the fill;
16. (run after 15) the TPC-H queries no earlier phase runs, at --q4-scale:
   (a) q2, q7, q8, q11, q14, q15, q16, q17, q18, q19, q20 and q22 local in
   auto mode, then q14 and q19 under fused_pallas (dict_filter on their
   LIKE and IN lists): each after every cache is dropped, a cold run, best
   of 3 and one traced warm run (reached late, LATE_AT: one warm run and
   no traced run);
   every answer equal to engine=cpu's (floats within F32_LANE_RTOL where
   the run launched masked_group_reduce), every device node claimed, run
   and fallen back as on the port's CPU form (computed in a worker, as
   phase 10's), each declining node with the CPU form's reason, every
   fused_pallas sort stage launching its kernel; per query the walls,
   plan_s, each partial stage's fusion mode and reason, each sort node's
   decisions, the launches of the six kernels per run, the time any host
   hash join ran (the union of their spans, by join mode), busy time and
   idle share; (b) (a)'s twelve in auto mode through
   SessionContext.remote(addr) against phase 9's in-process cluster (one
   push executor pinned to card 0, one slot) with
   ballista.shuffle.reader.force_remote_read: a warm-up run and one run,
   each answer equal to (a)'s, every device stage on the card in every
   task, one pass a task, no fallback, every read over Flight; per query
   the walls, stages, tasks, device passes and launches (the remote
   mode runs the twelve only: with all 22 the phase overran the 120 s it
   may take of the run's limit, PERF.md §4);
17. print one JSON line of kernel numbers (each kernel's launches on every
   path above, the standalone and remote modes', TPC-DS's, the daemon's,
   the serving phase's, the CLI's, the mesh's, the cold path's and phase
   16's apart as well), the card line, and last {"ok": true, "device": {...}}.

For the run's time limit, the engine=cpu answers of phases 4-16 (with
the CPU-form claims of phases 10 and 16) are computed in ORACLE_WORKERS child
processes while the data is generated (as many again for --scale's), and
all of them are in before the first timed run: no timed window shares the
host with the generator or the CPU engine. Meanwhile the card runs phase
10 (a), right after phase 3, as the answers at scale 0.1 come in (its
walls are taken beside the generator and the workers), and q21 large's
fused_xla reference run (phase 6), whose wall is not a cell's. Host-bound
cells reached late keep one warm run, and phase 12 drops its traced runs
(LATE_AT).

Options: --scale (q1/q6/q5/q12 scale factor, default 10), --q4-scale
(default 1), --data-dir (default build/tpch), --tpcds-dir (default
build/tpcds; both under build/, listed in .gitignore).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 42
FILES_PER_TABLE = 8  # as bench.py generates its TPC-H data
TPCDS_SEED = 17  # TPC-DS as tests/test_tpcds.py generates it
TPCDS_FILES_PER_TABLE = 2
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
F32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
QUERY_CONFIG = {
    "ballista.executor.engine": "tpu",
    # final merges are a few hundred partial rows: without this the final
    # stage declines to the CPU engine by design (ballista.tpu.min.rows)
    "ballista.tpu.min.rows": 0,
    # phases 4-6 evict cold tables by dropping them, as they did before the
    # spill pool existed; phase 7 turns the pool on where it tests it
    "ballista.tpu.hbm.spill.enabled": False,
}
# phase 7's spill pool: on, with host buffers large enough that no table
# reaches the disk tier unless a check asks for it
SPILL_CONFIG = {**QUERY_CONFIG, "ballista.tpu.hbm.spill.enabled": True,
                "ballista.tpu.hbm.spill.host.bytes": 64 << 30}
# The run must end within 1200 s, and its host-bound phases run up to 1.3x
# (PR 11: the refused run against R3) or 1.5x (PR 10: R4 against R3)
# longer on one host than on another. A repeated cell whose warm runs are
# host-bound reached past its mark here (seconds since the start, about
# 1.15x where a host like PR 11 R3's reaches it) keeps one warm run
# instead of best of 3 (phase 12 drops its traced runs, q21 large, one
# warm run already, its traced run); every check of it stays.
LATE_AT = {"q21_large": 350.0, "remote": 800.0, "tpcds_big": 850.0, "serving": 900.0,
           "cold_path": 1080.0, "tpch22": 850.0}


def warm_runs(t0: float, cell: str) -> int:
    late = time.time() - t0 > LATE_AT[cell]
    if late:
        log(f"{cell} reached past {LATE_AT[cell]:g}s: its late form (one warm run, "
            "no traced serving runs)")
    return 1 if late else 3


def log(msg: str) -> None:
    print(f"[chip_smoke {time.strftime('%H:%M:%S')}] {msg}", file=sys.stderr, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------- data

# kind: (module, function, seed, files per table)
GENERATORS = {
    "tpch": ("ballista_tpu_torch.testing.tpchgen", "generate_tpch", SEED, FILES_PER_TABLE),
    "tpcds": ("ballista_tpu_torch.testing.tpcdsgen", "generate_tpcds",
              TPCDS_SEED, TPCDS_FILES_PER_TABLE),
}


def _manifest(scale: float, kind: str = "tpch") -> dict:
    module, _fn, seed, files = GENERATORS[kind]
    return {"generator": module, "scale": scale, "seed": seed, "files_per_table": files}


def data_ready(path: str, scale: float, kind: str = "tpch") -> bool:
    try:
        with open(os.path.join(path, "manifest.json")) as f:
            return json.load(f) == _manifest(scale, kind)
    except (OSError, ValueError):
        return False


def start_generate(path: str, scale: float, kind: str = "tpch") -> subprocess.Popen | None:
    """Generate `kind`'s tables at `scale` into `path` in a child process
    (None when a matching manifest says they are there already). The
    manifest is written last, so a cut run never looks complete."""
    if data_ready(path, scale, kind):
        return None
    try:  # a stale manifest must not mark the data ready before it is
        os.remove(os.path.join(path, "manifest.json"))
    except FileNotFoundError:
        pass
    module, fn, seed, files = GENERATORS[kind]
    code = (
        "import json, os, sys\n"
        f"from {module} import {fn} as generate\n"
        "path, scale, seed, fpt, manifest = sys.argv[1], float(sys.argv[2]), "
        "int(sys.argv[3]), int(sys.argv[4]), sys.argv[5]\n"
        "generate(path, scale=scale, seed=seed, files_per_table=fpt)\n"
        "with open(os.path.join(path, 'manifest.json.tmp'), 'w') as f:\n"
        "    f.write(manifest)\n"
        "os.replace(os.path.join(path, 'manifest.json.tmp'), "
        "os.path.join(path, 'manifest.json'))\n")
    return subprocess.Popen(
        [sys.executable, "-c", code, path, str(scale), str(seed),
         str(files), json.dumps(_manifest(scale, kind))], cwd=ROOT)


def wait_generate(proc: subprocess.Popen | None, path: str, scale: float,
                  kind: str = "tpch") -> None:
    if proc is not None and proc.wait() != 0:
        raise RuntimeError(f"{kind} generation at scale {scale} exited {proc.returncode}")
    if not data_ready(path, scale, kind):
        raise RuntimeError(f"{kind} data at {path} is incomplete")


# ---------------------------------------------------------------- oracle

def _query_sql(q: int) -> str:
    with open(os.path.join(ROOT, "benchmarks", "tpch", "queries", f"q{q}.sql")) as f:
        return f.read()


def cpu_engine_answer(sql: str, data_dir: str):
    """The port's engine=cpu answer to `sql` over `data_dir`, and its wall."""
    from ballista_tpu_torch.client.context import SessionContext
    from ballista_tpu_torch.config import BallistaConfig
    from ballista_tpu_torch.testing.tpchgen import register_tpch

    ctx = SessionContext(BallistaConfig({"ballista.executor.engine": "cpu"}))
    register_tpch(ctx, data_dir)
    t0 = time.time()
    tbl = ctx.sql(sql).collect()
    return tbl, time.time() - t0


def _oracle_job(sql: str, data_dir: str):
    """cpu_engine_answer in a worker, the table as an Arrow IPC stream: a
    pickled table carries every chunk's whole parent buffers, many times
    the table's own bytes for the sort family's answers at SF10."""
    import pyarrow as pa

    tbl, seconds = cpu_engine_answer(sql, data_dir)
    sink = pa.BufferOutputStream()
    with pa.ipc.new_stream(sink, tbl.schema) as w:
        w.write_table(tbl)
    return sink.getvalue(), seconds


def _tpcds_sql(q: int) -> str:
    with open(os.path.join(ROOT, "benchmarks", "tpcds", "queries", f"q{q}.sql")) as f:
        return f.read()


def device_claims(physical) -> list:
    """[kind, device runs, fallbacks] of every device node of an executed
    plan, in plan order."""
    return [[type(n).__name__, n.tpu_count, n.fallback_count]
            for n in _walk(physical) if type(n).__name__ in DEVICE_NODE_KINDS]


def _decline_reasons(physical) -> list:
    return [n.decline_reason for n in _walk(physical)
            if getattr(n, "decline_reason", None) is not None]


def _cpu_form_job(kind: str, q: int, data_dir: str, extra: dict | None = None):
    """Query q of `kind` ("tpch" or "tpcds") over `data_dir` in a worker:
    the port's engine=cpu answer (an Arrow IPC stream) and its wall, and
    what the port's CPU form (engine=tpu after runtime.use_cpu(),
    QUERY_CONFIG and `extra`) does with it: the device claims, the decline
    reasons, and the error's type and message where it raises, which fails
    the query on the card. The CPU form's tables are dropped after it."""
    import pyarrow as pa

    from ballista_tpu_torch.client.context import SessionContext
    from ballista_tpu_torch.config import BallistaConfig
    from ballista_tpu_torch.engine.cuda_engine import maybe_compile_tpu
    from ballista_tpu_torch.ops.cuda import runtime
    from ballista_tpu_torch.ops.cuda.stage_compiler import clear_device_caches

    if kind == "tpcds":
        from ballista_tpu_torch.testing.tpcdsgen import register_tpcds as register
        sql = _tpcds_sql(q)
    else:
        from ballista_tpu_torch.testing.tpchgen import register_tpch as register
        sql = _query_sql(q)
    ctx = SessionContext(BallistaConfig({"ballista.executor.engine": "cpu"}))
    register(ctx, data_dir)
    t0 = time.time()
    tbl = ctx.sql(sql).collect()
    seconds = time.time() - t0
    sink = pa.BufferOutputStream()
    with pa.ipc.new_stream(sink, tbl.schema) as w:
        w.write_table(tbl)
    runtime.use_cpu()
    ctx = SessionContext(BallistaConfig({**QUERY_CONFIG, **(extra or {})}))
    register(ctx, data_dir)
    physical = maybe_compile_tpu(ctx.create_physical_plan(ctx.sql(sql).plan), ctx.config)
    try:
        ctx.execute_collect(physical)
        error = None
    except Exception as e:  # noqa: BLE001 — the card must raise the same
        error = [type(e).__name__, str(e)]
    finally:
        clear_device_caches()
    cpu_form = {"claims": device_claims(physical), "declines": _decline_reasons(physical),
                "error": error}
    return sink.getvalue(), seconds, cpu_form


ORACLE_WORKERS = 3  # engine=cpu answers computed at once


class CpuOracle:
    """The engine=cpu answers that phases 4-6 hold the card to. The CPU
    engine takes minutes over SF10, so `submit` hands (sql, data dir) jobs
    to ORACLE_WORKERS spawned processes while the data is generated, and
    `wait` collects every answer and stops them before the first timed run.
    Once the generators are done, `widen` adds as many processes again; a
    job goes to the pool with the fewest unfinished jobs. `answer` hands
    one out, computing it here
    for a job not submitted. A job that fails fails the run. The walls a
    worker records are taken beside the other workers and the generator."""

    def __init__(self):
        self.pools: list = []
        self.pending: dict = {}
        self.answers: dict = {}

    def widen(self) -> None:
        import multiprocessing
        from concurrent.futures import ProcessPoolExecutor

        self.pools.append(ProcessPoolExecutor(
            ORACLE_WORKERS, mp_context=multiprocessing.get_context("spawn")))

    def _submit(self, key, fn, *args) -> None:
        if not self.pools:
            self.widen()
        busy = {id(p): 0 for p in self.pools}
        for pool, fut in self.pending.values():
            busy[id(pool)] += not fut.done()
        pool = min(self.pools, key=lambda p: busy[id(p)])
        self.pending[key] = (pool, pool.submit(fn, *args))

    def submit(self, jobs) -> None:
        for job in jobs:
            self._submit(job, _oracle_job, *job)

    def submit_tpcds(self, queries, data_dir: str) -> None:
        for q in queries:
            self._submit(("tpcds", q, data_dir), _cpu_form_job, "tpcds", q, data_dir)

    def submit_tpch_forms(self, forms, data_dir: str) -> None:
        """(engine=cpu answer, wall, CPU form) of each TPC-H (query, mode
        name, extra config) in `forms`, read with `keyed(("tpch_form", q,
        name, data_dir))`."""
        for q, name, extra in forms:
            self._submit(("tpch_form", q, name, data_dir), _cpu_form_job, "tpch", q,
                         data_dir, extra)

    def _collect(self, job) -> None:
        import pyarrow as pa

        stream, *rest = self.pending.pop(job)[1].result()
        self.answers[job] = (pa.ipc.open_stream(stream).read_all(), *rest)

    def wait(self) -> None:
        for job in list(self.pending):
            self._collect(job)
        self.stop()

    def keyed(self, key):
        """(answer, wall) of a job `_submit`ted under `key`; it stays for
        the next read."""
        if key in self.pending:
            self._collect(key)
        return self.answers[key]

    def answer(self, sql: str, data_dir: str):
        return self.answers.pop((sql, data_dir), None) or cpu_engine_answer(sql, data_dir)

    def tpcds(self, q: int, data_dir: str):
        """(engine=cpu answer, its wall, the CPU form's claims) of TPC-DS q,
        submitted with submit_tpcds: the CPU form needs a process of its
        own (runtime.use_cpu() holds for the whole process). Waits for
        this job alone where it is still pending."""
        job = ("tpcds", q, data_dir)
        if job in self.pending:
            self._collect(job)
        return self.answers.pop(job)

    def stop(self) -> None:
        from multiprocessing import resource_tracker

        for pool in self.pools:
            pool.shutdown(cancel_futures=True)
        if self.pools:
            # the pools' locks started multiprocessing's resource tracker,
            # which would otherwise outlive this process by a moment
            resource_tracker._resource_tracker._stop()
        self.pools, self.pending = [], {}


ORACLE = CpuOracle()


# ---------------------------------------------------------------- kernels

def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_busy_ms(fn, iters: int = 1, by_name: dict | None = None) -> float | None:
    """Milliseconds in which the card ran at least one kernel, copy or fill
    while `fn` ran `iters` times: the union of the device events of a
    torch.profiler trace taken with CPU and CUDA activity. None when the
    trace holds no device event. `by_name`, when given, receives each
    device event name's [total ms, count]."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    if by_name is not None:
        for e in events:
            acc = by_name.setdefault(e.name, [0.0, 0])
            acc[0] += (e.time_range.end - e.time_range.start) / 1e3
            acc[1] += 1
    busy_us, reach = 0.0, float("-inf")
    for start, end in spans:
        if end > reach:
            busy_us += end - max(start, reach)
            reach = end
    return busy_us / 1e3 if spans else None


def check_busy_method(dev) -> bool:
    """Hold device_busy_ms against CUDA events on copies of 1 GiB, where
    launch gaps are negligible: the two must agree within 10%, and neither
    may beat the copy's byte floor."""
    import torch

    src = torch.empty(1 << 28, dtype=torch.float32, device=dev)
    dst = torch.empty_like(src)
    events_ms = cuda_ms(lambda: dst.copy_(src), 10)
    busy = device_busy_ms(lambda: dst.copy_(src), 10)
    floor_ms = 2 * src.numel() * 4 / HBM_BYTES_PER_S * 1e3
    del src, dst
    ok = (busy is not None and abs(busy / 10 - events_ms) <= 0.1 * events_ms
          and min(busy / 10, events_ms) >= floor_ms)
    log(f"profiler busy check on a 1 GiB copy: events {events_ms:.4f} ms, profiler "
        f"{'none' if busy is None else f'{busy / 10:.4f}'} ms, byte floor {floor_ms:.4f} ms"
        f" -> {'trusted' if ok else 'NOT trusted: busy times reported as null'}")
    return ok


def _bound(n_bytes: int, n_ops: int) -> tuple[float, str]:
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = n_ops / F32_OPS_PER_S * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms else "operations")


def _timings(kernel, plain, library, busy_ok: bool, plain_iters: int = 10) -> dict:
    """CUDA-event means of the kernel's wrapper (50 launches), its plain
    form (`plain_iters`) and the library call (50; None: not timed); the
    device times of the kernel and of the library call from the checked
    profiler method (20 calls each), None when unchecked, with the kernel's
    device events per call by name (its launches, memsets and copies)."""
    by_name: dict = {}
    busy = device_busy_ms(kernel, 20, by_name=by_name) if busy_ok else None
    lib_busy = device_busy_ms(library, 20) if busy_ok and library is not None else None
    return {"ms": cuda_ms(kernel, 50), "device_ms": None if busy is None else busy / 20,
            "plain_ms": cuda_ms(plain, plain_iters, warmup=1),
            "library_ms": None if library is None else cuda_ms(library, 50),
            "library_device_ms": None if lib_busy is None else lib_busy / 20,
            "device_events_per_call": {n[:60]: c / 20 for n, (_, c) in by_name.items()}}


def _kernel_launches(rec: dict) -> float | None:
    """Kernel launches per call in the traced timing, memsets and copies
    left out; None when the trace was not taken."""
    events = rec.get("device_events_per_call")
    if not events:
        return None
    return sum(c for n, c in events.items() if not n.startswith(("Memset", "Memcpy")))


def gather_phase(dev, busy_ok: bool) -> list[dict]:
    """hash_probe and dict_filter against their plain forms: exact, reruns
    bitwise identical, at the main path's shapes and at large tables.
    Returns one record per kernel at its main-path shape, with hash_probe's
    other tables under "tables" and dict_filter's other LUTs under "cases"
    (dict_filter_cases)."""
    import numpy as np
    import torch

    from ballista_tpu_torch.ops.cuda import cuda_kernels as ck

    rng = np.random.default_rng(11)
    records = []
    optin = ck.hash_probe_smem_optin(dev)
    s_max = ck.hash_probe_block_max(optin)
    cut = s_max * ck.HP_SPLIT_MAX_QUARTERS // 4  # the split/cluster boundary
    log(f"hash_probe: opt-in shared memory {optin} B a block, S = {s_max} entries")
    # (label, P, N, T, share of table slots present): q5's nation join;
    # q21's supplier join at SF1 (its stage's [8, 2^20] lineitem stack,
    # 10,000 suppliers in 2^14 slots), the same table at [8, 2^23], and at
    # SF10 (100,000 suppliers in 2^17 slots); the largest table the engine
    # sends the kernel (pallas.max.probe.rows) with 30% of its keys absent;
    # and a table on each side of every regime boundary
    cases = [("q5_nation", 8, 8388608, 32, 25 / 32),
             ("q21_supplier_sf1", 8, 1048576, 1 << 14, 10000 / (1 << 14)),
             ("T=2^14", 8, 8388608, 1 << 14, 10000 / (1 << 14)),
             ("q21_supplier_sf10", 8, 8388608, 1 << 17, 100000 / (1 << 17)),
             ("engine_cap", 8, 8388608, 1 << 18, 0.7)]
    cases += [(f"edge {label}", 8, 8388608, T, 0.7) for label, T in (
        ("12288", 12288), ("12289", 12289), ("S", s_max), ("S+1", s_max + 1),
        ("9S/4", cut), ("9S/4+1", cut + 1), ("8S", 8 * s_max), ("8S+1", 8 * s_max + 1))]
    hp = {}
    for label, P, N, T, present in cases:
        table_np = np.full(T, -1, np.int32)
        slots = rng.choice(T, size=int(T * present), replace=False)
        table_np[slots] = rng.permutation(len(slots)).astype(np.int32)
        table = torch.as_tensor(table_np, device=dev)
        keys = torch.randint(0, T, (P, N), dtype=torch.int32, device=dev)
        mask = torch.rand((P, N), device=dev) < 0.9
        r1, m1 = ck.hash_probe(keys, table, mask)
        r2, m2 = ck.hash_probe(keys, table, mask)
        rp, mp = ck.hash_probe_plain(keys, table, mask)
        torch.cuda.synchronize()
        if not (torch.equal(r1, r2) and torch.equal(m1, m2)):
            raise AssertionError(f"hash_probe {label} T={T}: two runs differ bitwise")
        if not (torch.equal(r1, rp) and torch.equal(m1, mp)):
            raise AssertionError(f"hash_probe {label} T={T}: differs from the plain form")
        regime, cluster = ck.hash_probe_regime(T, optin)
        log(f"hash_probe {label} P={P} N={N} T={T} ({regime} regime, C={cluster}): exact, "
            "reruns bitwise identical")
        keys_l = keys.long()
        rec = _timings(lambda: ck.hash_probe(keys, table, mask),
                       lambda: ck.hash_probe_plain(keys, table, mask),
                       lambda: torch.take(table, keys_l), busy_ok)
        # keys (4 B) and mask (1 B) read, rows (4 B) and matched (1 B)
        # written per row, the table read once; a compare and a select per row
        rec["bound_ms"], rec["bound_by"] = _bound(P * N * 10 + T * 4, 2 * P * N)
        rec.update(label=label, shape=[P, N, T], regime=regime, cluster=cluster,
                   present=len(slots))
        log(f"hash_probe {label}: {rec['ms']:.4f} ms (device {rec['device_ms']}), bound "
            f"{rec['bound_ms']:.4f} ms, torch.take {rec['library_ms']:.4f} ms (device "
            f"{rec['library_device_ms']})")
        hp[label] = rec
        del keys, keys_l, mask, r1, r2, rp, m1, m2, mp
    main = hp.pop("q5_nation")
    main["tables"] = list(hp.values())
    records.append({"name": "hash_probe", "route": "cuda",
                    "source": "ballista_tpu_torch/ops/cuda/csrc/hash_probe.cu",
                    "replaces": "ballista_tpu/ops/tpu/pallas_kernels.py:185",
                    "max_abs_err": 0.0, **main})

    records.append(dict_filter_cases(dev, busy_ok, rng))
    return records


def _dict_filter_exact(label: str, codes, lut, mask) -> None:
    """dict_filter against its plain form: exact, two runs bitwise identical."""
    import torch

    from ballista_tpu_torch.ops.cuda import cuda_kernels as ck

    k1 = ck.dict_filter(codes, lut, mask)
    k2 = ck.dict_filter(codes, lut, mask)
    kp = ck.dict_filter_plain(codes, lut, mask)
    torch.cuda.synchronize()
    if not torch.equal(k1, k2):
        raise AssertionError(f"dict_filter {label}: two runs differ bitwise")
    if not torch.equal(k1, kp):
        raise AssertionError(f"dict_filter {label}: differs from the plain form")


def dict_filter_cases(dev, busy_ok: bool, rng) -> dict:
    """dict_filter at q12's shape [8, 2097152], timed with and without a
    mask at T = 8 (q12, register regime), 256 (q14's p_type), 4096, 2^17 and
    2^22 (global), torch.take beside each T; then every regime boundary
    (T = 32 | 33, the opt-in bitmap's last entry | one more) and the shared
    bitmap's packing (in every CTA | one launch first) at a ragged
    [8, 262147], exact only. Returns the record of T = 8 with a mask, the
    others under "cases"."""
    import torch

    from ballista_tpu_torch.ops.cuda import cuda_kernels as ck

    optin = ck.dict_filter_smem_optin(dev)
    B = ck.dict_filter_bitmap_max(optin)
    log(f"dict_filter: opt-in {optin} B a block, shared bitmap up to {B} entries")
    P, N = 8, 2097152
    df = {}
    for T in (8, 256, 4096, 1 << 17, 1 << 22):
        lut = torch.as_tensor(rng.random(T) < 0.4, device=dev)
        codes = torch.randint(0, T, (P, N), dtype=torch.int32, device=dev)
        mask = torch.rand((P, N), device=dev) < 0.9
        codes_l = codes.long()
        regime = ck.dict_filter_regime(T, optin)
        library = lambda: torch.take(lut, codes_l)  # noqa: E731
        for masked in (True, False):
            m = mask if masked else None
            label = f"T={T} {'mask' if masked else 'no mask'}"
            _dict_filter_exact(label, codes, lut, m)
            rec = _timings(lambda: ck.dict_filter(codes, lut, m),
                           lambda: ck.dict_filter_plain(codes, lut, m),
                           library if masked else None, busy_ok)
            if not masked:  # the same torch.take, timed once a T
                rec["library_ms"] = df[(T, True)]["library_ms"]
                rec["library_device_ms"] = df[(T, True)]["library_device_ms"]
            # codes (4 B) and mask (1 B, none without one) read, keep (1 B)
            # written per row, the LUT read once; a compare and an and per row
            rec["bound_ms"], rec["bound_by"] = _bound(P * N * (6 if masked else 5) + T,
                                                      2 * P * N)
            rec.update(shape=[P, N, T], regime=regime, masked=masked)
            log(f"dict_filter {label} ({regime}): exact, reruns bitwise identical; "
                f"{rec['ms']:.4f} ms (device {rec['device_ms']}), bound {rec['bound_ms']:.4f} ms, "
                f"torch.take {rec['library_ms']:.4f} ms (device {rec['library_device_ms']})")
            df[(T, masked)] = rec
        del codes, codes_l, mask
    for T in (32, 33, ck.DF_CTA_PACK_MAX, ck.DF_CTA_PACK_MAX + 1, B, B + 1):
        lut = torch.as_tensor(rng.random(T) < 0.4, device=dev)
        codes = torch.randint(0, T, (8, 262147), dtype=torch.int32, device=dev)
        mask = torch.rand((8, 262147), device=dev) < 0.9
        for m in (mask, None):
            _dict_filter_exact(f"edge T={T}", codes, lut, m)
        log(f"dict_filter edge T={T} ({ck.dict_filter_regime(T, optin)}), with and without a "
            "mask: exact, reruns bitwise identical")
    main = df.pop((8, True))
    main["cases"] = list(df.values())
    return {"name": "dict_filter", "route": "cuda",
            "source": "ballista_tpu_torch/ops/cuda/csrc/dict_filter.cu",
            "replaces": "ballista_tpu/ops/tpu/pallas_kernels.py:467",
            "max_abs_err": 0.0, **main}


def _mgr_inputs(P: int, N: int, G: int, dev, rng, kind: str = "random"):
    """masked_group_reduce inputs: "random" (ids in [0, G), 70% of rows
    kept); "none" (every row masked out); "special" (NaN and +-inf
    values, some masked out); "outside" (ids below 0 and at or past G)."""
    import numpy as np
    import torch

    vals = rng.uniform(-5, 5, (P, N)).astype(np.float32)
    gid = rng.integers(0, G, (P, N)).astype(np.int32)
    mask = rng.random((P, N)) < 0.7
    if kind == "none":
        mask[:] = False
    elif kind == "special":
        for v, share in ((np.nan, 0.001), (np.inf, 0.001), (-np.inf, 0.001)):
            vals[rng.random((P, N)) < share] = v
    elif kind == "outside":
        gid[rng.random((P, N)) < 0.2] = G
        gid[rng.random((P, N)) < 0.1] = -1
    return tuple(torch.as_tensor(x, device=dev) for x in (vals, gid, mask))


def kernel_phase(dev, busy_ok: bool) -> dict:
    """masked_group_reduce against its plain form at q4's shape and at the
    edges (G = 1, 8, 32, 33, 300, 4096; P = 1 and 8; N no multiple of a
    block's span, below one chunk; every row masked out; NaN and inf rows;
    ids outside [0, G)): counts exact, sums within rtol 1e-4 with NaN
    exactly where the plain form has it, reruns bitwise identical. Times
    G = 8 (q4) and G = 4096 (the engine's cap), each beside its bound and
    torch.bincount. Returns the q4-shape record, G = 4096 under "also"."""
    import numpy as np
    import torch

    from ballista_tpu_torch.ops.cuda import cuda_kernels as ck

    rng = np.random.default_rng(7)
    timed = {}
    cases = [(8, 262144, G, "random") for G in (8, 4096, 1, 32, 33, 300)]
    cases += [(1, 262144, 33, "random"), (8, 100003, 8, "random"), (8, 100003, 4096, "random"),
              (3, 7, 8, "random"), (3, 7, 300, "random"), (8, 65536, 8, "none"),
              (8, 65536, 4096, "none"), (8, 65536, 8, "special"), (8, 65536, 300, "special"),
              (2, 65537, 8, "outside"), (2, 65537, 4096, "outside")]
    for P, N, G, kind in cases:
        vals, gid, mask = _mgr_inputs(P, N, G, dev, rng, kind)
        s1, c1 = ck.masked_group_reduce(vals, gid, mask, G)
        s2, c2 = ck.masked_group_reduce(vals, gid, mask, G)
        sp, cp = ck.masked_group_reduce_plain(vals, gid, mask, G)
        torch.cuda.synchronize()
        what = f"masked_group_reduce P={P} N={N} G={G} {kind}"
        if not (torch.equal(s1.view(torch.int32), s2.view(torch.int32)) and torch.equal(c1, c2)):
            raise AssertionError(f"{what}: two runs differ bitwise")
        if not torch.equal(c1, cp):
            raise AssertionError(f"{what}: counts differ from the plain form")
        if not (torch.equal(torch.isnan(s1), torch.isnan(sp))
                and torch.allclose(s1, sp, rtol=1e-4, atol=1e-4, equal_nan=True)):
            raise AssertionError(f"{what}: sums differ from the plain form")
        finite = torch.isfinite(sp)
        err = float((s1 - sp)[finite].abs().max()) if bool(finite.any()) else 0.0
        log(f"{what}: counts exact, max_abs_err={err:.3e}, reruns bitwise identical")
        if kind != "random" or P != 8 or N != 262144 or G not in (8, 4096):
            continue
        key = (gid.long() + torch.arange(P, device=dev)[:, None] * G).flatten()
        weights = torch.where(mask, vals, 0.0).flatten()
        rec = _timings(lambda: ck.masked_group_reduce(vals, gid, mask, G),
                       lambda: ck.masked_group_reduce_plain(vals, gid, mask, G),
                       lambda: torch.bincount(key, weights, minlength=P * G), busy_ok,
                       plain_iters=10 if G <= 32 else 2)
        # value, id and mask read (9 B a row), a sum and a count written a
        # cell; one f32 add and one int add per row
        rec["bound_ms"], rec["bound_by"] = _bound(P * N * 9 + P * G * 8, 2 * P * N)
        rec.update(shape=[P, N, G], max_abs_err=err)
        rec["launches_per_call"] = _kernel_launches(rec)
        timed[G] = rec
    main = timed[8]
    main["also"] = timed[4096]
    return {"name": "masked_group_reduce", "route": "cuda",
            "source": "ballista_tpu_torch/ops/cuda/csrc/masked_group_reduce.cu",
            "replaces": "ballista_tpu/ops/tpu/pallas_kernels.py:125", **main}


def _sort_inputs(P: int, N: int, dev, seed: int, a_hi: int = 1000, kind: str = "random"):
    """Triples with ties on a and on (a, b), positions 0..N-1 and a tail of
    (i64 max, i64 max) padding sentinels, as the sort stage pads. kind
    "ties": every lane equal but for pos; "sentinels": every lane a
    padding sentinel, pos included; "descending": a zero (the null-rank
    plane of a non-null key) and b falling, so every lane is a new
    minimum; "path": the top-k stage's operands, a zero and b a key in
    [0, a_hi), with 1,000,000 real rows (one partsupp file at SF10) when
    N = 2^20."""
    import torch

    g = torch.Generator(device="cpu").manual_seed(seed)
    a = torch.randint(0, a_hi, (P, N), generator=g, dtype=torch.int64)
    b = torch.randint(0, 3, (P, N), generator=g, dtype=torch.int64)
    pos = torch.arange(N, dtype=torch.int32).repeat(P, 1)
    if kind == "path":
        a[:] = 0
        b = torch.randint(0, a_hi, (P, N), generator=g, dtype=torch.int64)
    pad = N - 1_000_000 if kind == "path" and N > 1_000_000 else N // 8
    if pad:
        a[:, -pad:] = 2**63 - 1
        b[:, -pad:] = 2**63 - 1
    if kind == "ties":
        a[:] = 7
        b[:] = 3
    elif kind == "descending":
        a[:] = 0
        b[:] = torch.arange(N, 0, -1)
    elif kind == "sentinels":
        a[:] = 2**63 - 1
        b[:] = 2**63 - 1
        pos[:] = 2**31 - 1
    return a.to(dev), b.to(dev), pos.to(dev)


def _scan_inputs(N: int, dev, seed: int, dtype, p_boundary: float, specials: bool, P: int = 1):
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    if dtype in (torch.int32, torch.int64):
        v = rng.integers(-10**6, 10**6, (P, N))
    else:
        v = rng.uniform(-100.0, 100.0, (P, N))
        if specials:
            for val, share in ((np.nan, 0.01), (0.0, 0.02), (-0.0, 0.02),
                               (np.inf, 0.005), (-np.inf, 0.005)):
                v[rng.random((P, N)) < share] = val
    return (torch.as_tensor(v).to(dtype).to(dev),
            torch.as_tensor(rng.random((P, N)) < p_boundary).to(dev))


def _equal_bits(x, y) -> bool:
    import torch

    if x.dtype.is_floating_point:
        bits = torch.int32 if x.element_size() == 4 else torch.int64
        return torch.equal(x.view(bits), y.view(bits))
    return torch.equal(x, y)


def sort_family_phase(dev, busy_ok: bool) -> list[dict]:
    """segmented_sort, topk_select and segmented_scan against their plain
    forms at the sort family's path shapes: exact (float sums within rtol
    of the segment's sum of |v|), reruns bitwise identical. Returns one
    timing record per kernel, at the window path's shape."""
    import math

    import torch

    from ballista_tpu_torch.ops.cuda import cuda_kernels as ck

    records = []
    sort = {}
    # the path's shapes, then the edges: rows below the tile, an odd count
    # of merge passes, P > 1, rows of sentinels only, ties everywhere
    for P, N, kind in ((1, 1 << 20, "random"), (1, 1 << 18, "random"), (4, 4096, "random"),
                       (3, 512, "random"), (2, 2, "random"), (3, 1, "random"),
                       (1, 16384, "random"), (3, 1 << 15, "random"),
                       (2, 1 << 16, "sentinels"), (1, 1 << 20, "ties")):
        a, b, pos = _sort_inputs(P, N, dev, seed=N + P, kind=kind)
        r1 = ck.segmented_sort(a, b, pos)
        r2 = ck.segmented_sort(a, b, pos)
        rp = ck.segmented_sort_plain(a, b, pos)
        torch.cuda.synchronize()
        what = f"segmented_sort [{P}, {N}] {kind}"
        if not all(torch.equal(x, y) for x, y in zip(r1, r2)):
            raise AssertionError(f"{what}: two runs differ bitwise")
        if not all(torch.equal(x, y) for x, y in zip(r1, rp)):
            raise AssertionError(f"{what}: differs from the plain form")
        log(f"{what} ({ck.sort_plan(N)[1]} merge passes): exact, reruns bitwise identical")
        if P != 1 or kind != "random" or N < 1 << 18:
            continue

        def two_pass(a=a, b=b):  # two stable torch.sort passes, b then a
            i1 = torch.sort(b, dim=-1, stable=True).indices
            i2 = torch.sort(torch.gather(a, -1, i1), dim=-1, stable=True).indices
            return torch.gather(i1, -1, i2)

        rec = _timings(lambda a=a, b=b, pos=pos: ck.segmented_sort(a, b, pos),
                       lambda a=a, b=b, pos=pos: ck.segmented_sort_plain(a, b, pos),
                       two_pass, busy_ok)
        # each lane read once and written once (20 B each way); N log2 N
        # compares, the least any comparison sort needs, as operations
        rec["comparisons"] = P * N * int(math.log2(N))
        rec["bound_ms"], rec["bound_by"] = _bound(P * N * 40, rec["comparisons"])
        rec["shape"] = [P, N]
        rec["launches_per_call"] = _kernel_launches(rec)
        if rec["launches_per_call"] is not None and rec["launches_per_call"] > 12:
            raise AssertionError(f"segmented_sort [{P}, {N}]: {rec['launches_per_call']} "
                                 "launches a call, at most 12 expected")
        sort[N] = rec
        del a, b, pos, r1, r2, rp
    main = sort[1 << 20]
    main["also"] = sort[1 << 18]
    records.append({"name": "segmented_sort", "route": "cuda",
                    "source": "ballista_tpu_torch/ops/cuda/csrc/segmented_sort.cu",
                    "replaces": "ballista_tpu/ops/tpu/pallas_kernels.py:284",
                    "max_abs_err": 0.0, **main})

    # the path's shape with ties at every cut (50 values), then the edges:
    # random, descending, all ties and all sentinels; P = 3; rows from one
    # lane to 2^20; C from 128 to 2048 through the filter, 4096 through the
    # full sort
    N = 1 << 20
    cases = [(1, N, "random", (1, 100, 1000, 4096), 50)]
    cases += [(3, n, kind, (1, 100, 1000, 1024, 3000, 4096), 1000)
              for kind in ("random", "descending", "ties", "sentinels")
              for n in (1, 2, 512, 2048, 4096, N)]
    for P, n, kind, ks, a_hi in cases:
        a, b, pos = _sort_inputs(P, n, dev, seed=n + P + len(kind), a_hi=a_hi, kind=kind)
        for k in ks:
            r1 = ck.topk_select(a, b, pos, k)
            r2 = ck.topk_select(a, b, pos, k)
            rp = ck.topk_select_plain(a, b, pos, k)
            torch.cuda.synchronize()
            what = f"topk_select [{P}, {n}] {kind} k={k}"
            if not all(torch.equal(x, y) for x, y in zip(r1, r2)):
                raise AssertionError(f"{what}: two runs differ bitwise")
            if not all(x.shape == (P, min(k, n)) and torch.equal(x, y) for x, y in zip(r1, rp)):
                raise AssertionError(f"{what}: differs from the plain form")
        log(f"topk_select [{P}, {n}] {kind} k={ks}: exact, reruns bitwise identical")
        del a, b, pos
    # timed on the top-k stage's operands (a zero for a non-null key, b the
    # key: ps_supplycost in cents, pos the position), and on descending b
    topk = {}
    for kind in ("path", "descending"):
        a, b, pos = _sort_inputs(1, N, dev, seed=5, a_hi=100_000, kind=kind)
        k = 100
        rec = _timings(lambda: ck.topk_select(a, b, pos, k),
                       lambda: ck.topk_select_plain(a, b, pos, k),
                       lambda: torch.topk(b, k, dim=-1, largest=False), busy_ok)
        c = ck._topk_chunk(k, N)
        # a and b of every lane read (a is the null-rank plane, so b decides,
        # and pos is needed only where (a, b) passes), C triples written; one
        # compare a lane. PR 3's bound read pos too: 20 B a lane.
        rec["bound_ms"], rec["bound_by"] = _bound(N * 16 + c * 20, N)
        rec["bound_ms_20B_a_lane"] = _bound(N * 20 + k * 20, N)[0]
        rec.update(shape=[1, N], k=k, input=kind)
        rec["launches_per_call"] = _kernel_launches(rec)
        topk[kind] = rec
        del a, b, pos
    main = topk["path"]
    main["also"] = topk["descending"]
    records.append({"name": "topk_select", "route": "cuda",
                    "source": "ballista_tpu_torch/ops/cuda/csrc/topk_select.cu",
                    "replaces": "ballista_tpu/ops/tpu/pallas_kernels.py:351",
                    "max_abs_err": 0.0, **main})

    scan = {}
    sum_err = {}
    # (dtype, func, boundary share, specials, P, N): the path's shape, no
    # boundary across 256 tiles, then the edges: a boundary on every lane,
    # P > 1 over several tiles, rows below the tile, one lane
    cases = [(torch.int64, "sum", 1 / 15, False), (torch.int64, "max", 1 / 15, False),
             (torch.int64, "sum", 0.0, False), (torch.float64, "max", 1 / 15, True),
             (torch.float64, "min", 1 / 15, True), (torch.float64, "max", 0.0, True),
             (torch.float32, "sum", 1 / 15, False), (torch.float64, "sum", 1 / 15, False),
             (torch.float32, "sum", 0.0, False), (torch.float64, "sum", 0.0, False),
             (torch.int64, "sum", 1.0, False), (torch.float64, "max", 1.0, True),
             (torch.int32, "min", 0.001, False, 3, 1 << 14),
             (torch.float32, "max", 0.001, True, 3, 1 << 14),
             (torch.float64, "sum", 0.15, False, 3, 1024), (torch.int64, "max", 0.0, False, 2, 1)]
    for i, (dtype, func, p_b, specials, *shape) in enumerate(cases):
        P, n = shape or (1, N)
        v, f = _scan_inputs(n, dev, 30 + i, dtype, p_b, specials, P=P)
        r1 = ck.segmented_scan(v, f, func)
        r2 = ck.segmented_scan(v, f, func)
        rp = ck.segmented_scan_plain(v, f, func)
        torch.cuda.synchronize()
        what = (f"segmented_scan [{P}, {n}] {str(dtype)[6:]} {func} "
                f"boundary share {p_b:.4f}")
        if not _equal_bits(r1, r2):
            raise AssertionError(f"{what}: two runs differ bitwise")
        if func == "sum" and dtype.is_floating_point:
            rtol = 1e-5 if dtype == torch.float32 else 1e-12
            scale = ck.segmented_scan_plain(v.abs(), f, "sum")
            err = (r1 - rp).abs()
            if not bool((err <= rtol * scale).all()):
                raise AssertionError(f"{what}: beyond rtol {rtol} of the segment's sum of |v|")
            sum_err[f"[{P}, {n}] {str(dtype)[6:]} boundary share {p_b:.4f}"] = float(err.max())
            log(f"{what}: max_abs_err={float(err.max()):.3e} within rtol {rtol} "
                "of the segment's sum of |v|, reruns bitwise identical")
        else:
            if not _equal_bits(r1, rp):
                raise AssertionError(f"{what}: differs from the plain form")
            log(f"{what}{' (NaN, +-0, +-inf)' if specials else ''}: bitwise equal, "
                "reruns bitwise identical")
        if (dtype, func, p_b) in ((torch.int64, "sum", 1 / 15), (torch.float64, "max", 1 / 15)):
            # one kernel launch and one memset of the tile counters a call
            library = ((lambda v=v: torch.cumsum(v, dim=1)) if func == "sum"
                       else (lambda v=v: torch.cummax(v, dim=1)))
            rec = _timings(lambda v=v, f=f, func=func: ck.segmented_scan(v, f, func),
                           lambda v=v, f=f, func=func: ck.segmented_scan_plain(v, f, func),
                           library, busy_ok)
            # value (8 B) and flag (1 B) read, value (8 B) written; one op a lane
            rec["bound_ms"], rec["bound_by"] = _bound(N * 17, N)
            rec.update(shape=[1, N], dtype=str(dtype)[6:], func=func)
            rec["launches_per_call"] = _kernel_launches(rec)
            events = rec["device_events_per_call"]
            if events and (rec["launches_per_call"] > 1 or sum(
                    c for name, c in events.items() if name.startswith(("Memset", "Memcpy"))) > 1):
                raise AssertionError(f"{what}: device events per call {events}, one kernel "
                                     "and at most one memset expected")
            scan[(dtype, func)] = rec
        del v, f, r1, r2, rp
    main = scan[(torch.int64, "sum")]
    main["also"] = scan[(torch.float64, "max")]
    main["float_sum_max_abs_err"] = sum_err
    records.append({"name": "segmented_scan", "route": "cuda",
                    "source": "ballista_tpu_torch/ops/cuda/csrc/segmented_scan.cu",
                    "replaces": "ballista_tpu/ops/tpu/pallas_kernels.py:421",
                    "max_abs_err": 0.0, **main})
    return records


# ---------------------------------------------------------------- path

def _walk(node):
    yield node
    for c in node.children():
        yield from _walk(c)


def compare_answers(dev_tbl, cpu_tbl, q: int | str, rtol: float = 1e-9) -> None:
    """`q`: a TPC-H query number, or a label of its own."""
    import numpy as np
    import pyarrow as pa

    label = f"q{q}" if isinstance(q, int) else q

    if dev_tbl.schema != cpu_tbl.schema:
        raise AssertionError(f"{label}: schema {dev_tbl.schema} != {cpu_tbl.schema}")
    if dev_tbl.num_rows != cpu_tbl.num_rows:
        raise AssertionError(f"{label}: {dev_tbl.num_rows} rows != {cpu_tbl.num_rows}")
    for i, (name, f) in enumerate(zip(dev_tbl.column_names, dev_tbl.schema)):
        a = dev_tbl.column(i).combine_chunks()
        b = cpu_tbl.column(i).combine_chunks()
        if pa.types.is_floating(f.type):
            x = a.to_numpy(zero_copy_only=False)
            y = b.to_numpy(zero_copy_only=False)
            if not np.allclose(x, y, rtol=rtol, atol=0.0, equal_nan=True):
                raise AssertionError(f"{label}: column {name} differs: {x[:4]} vs {y[:4]}")
        elif not a.equals(b):
            raise AssertionError(f"{label}: column {name} differs exactly")


# per query: the fusion mode the reference reports, the config it runs
# with, the HashJoinExecs its device stage must hold (None: at least one),
# and the kernel each of its runs must launch, with the least count
PATHS = {
    1: ("fused_xla", {}, 0, None),
    6: ("fused_xla", {}, 0, None),
    # requests fused_pallas; the money sums fail the kernel's gate, while
    # hash_probe still runs for the nation (T=32) and region (T=4) joins
    5: ("fused_xla", {}, 4, ("hash_probe", 2)),
    12: ("fused_xla", {"ballista.tpu.fusion.mode": "fused_pallas"}, 1, ("dict_filter", 1)),
    4: ("fused_pallas", {}, None, ("masked_group_reduce", 1)),
}


def run_query(q: int, data_dir: str, dev, busy_ok: bool, answers: dict | None = None) -> dict:
    from ballista_tpu_torch.client.context import SessionContext
    from ballista_tpu_torch.config import BallistaConfig
    from ballista_tpu_torch.engine.cuda_engine import maybe_compile_tpu
    from ballista_tpu_torch.ops.cuda import cuda_kernels as ck
    from ballista_tpu_torch.ops.cuda.final_stage import TpuFinalStageExec
    from ballista_tpu_torch.ops.cuda.stage_compiler import DEVICE_CACHE, RUN_STATS, TpuStageExec
    from ballista_tpu_torch.plan.physical import HashJoinExec
    from ballista_tpu_torch.testing.tpchgen import register_tpch

    with open(os.path.join(ROOT, "benchmarks", "tpch", "queries", f"q{q}.sql")) as f:
        sql = f.read()
    cpu_tbl, cpu_s = ORACLE.answer(sql, data_dir)

    want, extra_cfg, n_joins, kernel = PATHS[q]
    ctx = SessionContext(BallistaConfig({**QUERY_CONFIG, **extra_cfg}))
    register_tpch(ctx, data_dir)
    rows = ctx.catalog.get("lineitem").statistics().num_rows or 0
    times, plan_times, runs, run_launches = [], [], [], []
    for i in range(4):  # one warm-up, then best of 3
        before = dict(ck.LAUNCHES)
        t0 = time.time()
        physical = maybe_compile_tpu(ctx.create_physical_plan(ctx.sql(sql).plan), ctx.config)
        plan_s = time.time() - t0
        tbl = ctx.execute_collect(physical)
        wall = time.time() - t0
        run_launches.append({k: ck.LAUNCHES[k] - before[k] for k in before})
        stages = [n for n in _walk(physical)
                  if isinstance(n, (TpuStageExec, TpuFinalStageExec))]
        recs = RUN_STATS.stages()
        runs.append((stages, {s.fingerprint: dict(recs.get(_tag(s), {}))
                              for s in stages if isinstance(s, TpuStageExec)}))
        if i:
            times.append(wall)
            plan_times.append(plan_s)
        else:
            cold_wall = wall
        compare_answers(tbl, cpu_tbl, q)
    stages = [s for st, _ in runs for s in st]
    partial = [s for s in runs[0][0] if isinstance(s, TpuStageExec)]
    if not partial:
        raise AssertionError(f"q{q}: no device partial stage was planned")
    for s in stages:
        if s.tpu_count < 1 or s.fallback_count != 0:
            raise AssertionError(f"q{q}: {s.node_str()} did not run on the card "
                                 f"(device_runs={s.tpu_count}, fallbacks={s.fallback_count})")
    cold = runs[0][1][partial[0].fingerprint]
    best = min(range(3), key=lambda k: times[k])
    warm = runs[best + 1][1][partial[0].fingerprint]
    mode = warm.get("fusion_mode")
    if mode != want:
        raise AssertionError(f"q{q}: fusion_mode {mode!r}, the reference picks {want!r}")
    if q == 5 and warm.get("fusion_reason") != "grouped agg, G=32 fits the kernel family":
        raise AssertionError(f"q5: fusion_reason {warm.get('fusion_reason')!r}")
    joins = sum(isinstance(op, HashJoinExec) for op in partial[0].ops)
    if (joins < 1) if n_joins is None else (joins != n_joins):
        raise AssertionError(f"q{q}: the device stage holds {joins} joins, "
                             f"expected {n_joins or 'at least 1'}")
    if kernel is not None:
        name, least = kernel
        per_run = [r[name] for r in run_launches]
        if min(per_run) < least:
            raise AssertionError(f"q{q}: {name} launched {per_run} times per run, "
                                 f"at least {least} expected")
    dt = DEVICE_CACHE.peek(partial[0].scan, dev)

    def one_run():
        physical = maybe_compile_tpu(ctx.create_physical_plan(ctx.sql(sql).plan), ctx.config)
        ctx.execute_collect(physical)

    # a warm run reads every column of the stage's cached table at least
    # once: a busy time below that byte floor means dropped events
    busy_floor_ms = (cold.get("device_bytes") or 0) / HBM_BYTES_PER_S * 1e3
    t0 = time.time()
    by_name: dict = {}
    busy = device_busy_ms(one_run, by_name=by_name) if busy_ok else None
    # where the traced run's device time went: the six largest event names
    top_ops = sorted(([n[:80], ms, c] for n, (ms, c) in by_name.items()),
                     key=lambda r: -r[1])[:6]
    traced_wall = time.time() - t0
    if busy is not None and busy < busy_floor_ms:
        log(f"q{q}: profiler busy {busy:.4f} ms is below the table's byte floor "
            f"{busy_floor_ms:.4f} ms: reported as null")
        busy = None
    if answers is not None:
        answers[q] = (tbl, cpu_tbl)  # the device answer of the last timed run
    return {
        "query": f"q{q}", "wall_s": times[best], "times_s": times,
        "plan_s": plan_times[best],
        "lineitem_rows": rows, "lineitem_rows_per_s": rows / times[best],
        "cold_wall_s": cold_wall, "fill_s": cold.get("fill_s"), "encode_s": cold.get("encode_s"),
        "upload_s": cold.get("upload_s"), "build_s": cold.get("build_s"),
        "warm_build_s": warm.get("build_s"), "exec_s": warm.get("exec_s"),
        "fused_kernel_s": warm.get("fused_kernel_s"),
        "device_bytes": cold.get("device_bytes"), "fusion_mode": mode,
        "fusion_reason": warm.get("fusion_reason"),
        "hbm_plan_reason": cold.get("hbm_plan_reason"),
        "stage_shape": list(dt.shape) if dt is not None else None,
        "kernel_launches_per_run": run_launches, "cpu_engine_s": cpu_s,
        "device_nodes": _device_nodes(runs[best + 1][0]),
        # the last run's sort and window stages outside the final stage
        "sort_stages": [n.node_str() for n in _walk(physical)
                        if type(n).__name__ in SORT_NODE_KINDS],
        "traced_wall_s": traced_wall, "device_busy_ms": busy, "top_device_ops": top_ops,
        "busy_floor_ms": busy_floor_ms,
        "device_idle_share": None if busy is None else 1.0 - busy / 1e3 / traced_wall,
    }


# the sort family's queries, with the kernel launches each run must make
# (8 files per table, 16 shuffle partitions): win_orders has 16 window
# stages of two LSD sort passes and five scans each, topk_partsupp one
# top-k per file partition, sort_customer two passes per file partition
SORT_QUERIES = {
    "win_orders": (
        "SELECT o_orderkey, o_custkey, o_orderdate, o_totalprice, "
        "row_number() OVER (PARTITION BY o_custkey ORDER BY o_orderdate) AS rn, "
        "rank() OVER (PARTITION BY o_custkey ORDER BY o_orderdate) AS rk, "
        "count(*) OVER (PARTITION BY o_custkey ORDER BY o_orderdate) AS cnt, "
        "max(o_totalprice) OVER (PARTITION BY o_custkey ORDER BY o_orderdate) AS mx "
        "FROM orders",
        {"segmented_sort": 32, "topk_select": 0, "segmented_scan": 80}),
    "topk_partsupp": (
        "SELECT ps_partkey, ps_suppkey, ps_supplycost, ps_availqty FROM partsupp "
        "ORDER BY ps_supplycost LIMIT 100",
        {"segmented_sort": 0, "topk_select": 8, "segmented_scan": 0}),
    "sort_customer": (
        "SELECT c_custkey, c_name, c_nationkey, c_acctbal FROM customer "
        "ORDER BY c_nationkey, c_acctbal DESC",
        {"segmented_sort": 16, "topk_select": 0, "segmented_scan": 0}),
}
SORT_CONFIG = {**QUERY_CONFIG, "ballista.tpu.sort.pallas.max.rows": 1 << 20}


def run_sort_query(name: str, data_dir: str, dev, busy_ok: bool) -> dict:
    from ballista_tpu_torch.client.context import SessionContext
    from ballista_tpu_torch.config import BallistaConfig
    from ballista_tpu_torch.engine.cuda_engine import maybe_compile_tpu
    from ballista_tpu_torch.ops.cuda import cuda_kernels as ck
    from ballista_tpu_torch.ops.cuda.sort_window import TpuSortStageExec, TpuWindowStageExec
    from ballista_tpu_torch.ops.cuda.stage_compiler import RUN_STATS
    from ballista_tpu_torch.testing.tpchgen import register_tpch

    sql, want_launches = SORT_QUERIES[name]
    cpu_tbl, cpu_s = ORACLE.answer(sql, data_dir)

    ctx = SessionContext(BallistaConfig(dict(SORT_CONFIG)))
    register_tpch(ctx, data_dir)
    times, plan_times, kernel_s, run_launches, modes = [], [], [], [], []
    for i in range(4):  # one warm-up, then best of 3
        ck.reset_launches()
        k0 = RUN_STATS.snapshot().get("sort_kernel_s", 0.0)
        t0 = time.time()
        physical = maybe_compile_tpu(ctx.create_physical_plan(ctx.sql(sql).plan), ctx.config)
        plan_s = time.time() - t0
        tbl = ctx.execute_collect(physical)
        wall = time.time() - t0
        run_launches.append(dict(ck.LAUNCHES))
        stats = RUN_STATS.snapshot()
        kernel_s.append(stats.get("sort_kernel_s", 0.0) - k0)
        modes.append((stats.get("fusion_mode"), stats.get("fusion_reason")))
        stages = [n for n in _walk(physical)
                  if isinstance(n, (TpuSortStageExec, TpuWindowStageExec))]
        if not stages:
            raise AssertionError(f"{name}: no sort or window stage was claimed")
        for st in stages:
            if st.tpu_count != st.output_partition_count() or st.fallback_count != 0:
                raise AssertionError(
                    f"{name}: {st.node_str()} ran {st.tpu_count} of "
                    f"{st.output_partition_count()} partitions on the card, "
                    f"{st.fallback_count} on the CPU")
        if not tbl.equals(cpu_tbl):
            raise AssertionError(f"{name}: the answer differs from the CPU engine's")
        got = {k: run_launches[-1][k] for k in want_launches}
        if got != want_launches:
            raise AssertionError(f"{name}: launches {got}, expected {want_launches}")
        if modes[-1][0] != "fused_pallas":
            raise AssertionError(f"{name}: auto mode chose {modes[-1]}, expected fused_pallas")
        if i:
            times.append(wall)
            plan_times.append(plan_s)
        else:
            cold_wall = wall
    log(f"{name}: equal to the CPU engine in row order, {len(stages)} stage(s) x "
        f"{stages[0].output_partition_count()} partitions on the card, "
        f"fused_pallas ({modes[-1][1]}), launches per run {got}")
    best = min(range(3), key=lambda k: times[k])

    def one_run():
        physical = maybe_compile_tpu(ctx.create_physical_plan(ctx.sql(sql).plan), ctx.config)
        ctx.execute_collect(physical)

    t0 = time.time()
    by_name: dict = {}
    ck.reset_launches()
    busy = device_busy_ms(one_run, by_name=by_name) if busy_ok else None
    traced_wall = time.time() - t0
    traced_launches = dict(ck.LAUNCHES)
    top_ops = sorted(([n[:80], ms, c] for n, (ms, c) in by_name.items()),
                     key=lambda r: -r[1])[:6]
    return {
        "query": name, "wall_s": times[best], "times_s": times, "plan_s": plan_times[best],
        "cold_wall_s": cold_wall, "sort_kernel_s": kernel_s[best + 1],
        "sort_kernel_s_runs": kernel_s, "rows_out": cpu_tbl.num_rows,
        "fusion_mode": modes[best + 1][0], "fusion_reason": modes[best + 1][1],
        "kernel_launches_per_run": run_launches, "traced_launches": traced_launches,
        "cpu_engine_s": cpu_s, "traced_wall_s": traced_wall, "device_busy_ms": busy,
        "top_device_ops": top_ops,
        "device_idle_share": None if busy is None else 1.0 - busy / 1e3 / traced_wall,
    }


# the sorted aggregation's queries, auto mode, with the data they run on
# ("big": --scale; "small": the q4 data, --q4-scale) and their config.
# q9 and q21 run on the small data: the port's engine=cpu takes 26 s (q9)
# and 17 s (q21) for their reference answers at SF1 on the H100 machine's
# host, and grows about tenfold to SF10, more than the run's time limit
# holds beside the other phases. q21 runs under
# fused_pallas: its group key s_name has 10,000 names at SF1 (100,000 at
# SF10), past the kernel family's 4096 groups, so auto mode takes fused_xla,
# which probes through plain gathers; fused_pallas sends its supplier and
# nation probes through hash_probe. q10 and q13 run on the small data too,
# for the run's time limit: at SF10 their cells took 74 s of a run (q13's
# cold run 43 s) and their engine=cpu answers 58 s of the oracle's.
SORTED_QUERIES = {
    3: ("big", {}),
    9: ("small", {}),
    10: ("small", {}),
    13: ("small", {}),
    21: ("small", {"ballista.tpu.fusion.mode": "fused_pallas"}),
}


def run_sorted_query(q: int, data_dir: str, dev, busy_ok: bool, extra_cfg: dict,
                     answers: dict | None = None) -> dict:
    """One query of the sorted aggregation's phase: the port's engine=cpu
    answer, then one warm-up and best of 3 with engine=tpu, each checked
    against it, every device stage on the card with no fallback and at
    least one partial stage sorted; one more, traced, run."""
    from ballista_tpu_torch.client.context import SessionContext
    from ballista_tpu_torch.config import BallistaConfig
    from ballista_tpu_torch.engine.cuda_engine import maybe_compile_tpu
    from ballista_tpu_torch.ops.cuda import cuda_kernels as ck
    from ballista_tpu_torch.ops.cuda.final_stage import TpuFinalStageExec
    from ballista_tpu_torch.ops.cuda.stage_compiler import RUN_STATS, TpuStageExec
    from ballista_tpu_torch.testing.tpchgen import register_tpch

    with open(os.path.join(ROOT, "benchmarks", "tpch", "queries", f"q{q}.sql")) as f:
        sql = f.read()
    cpu_tbl, cpu_s = ORACLE.answer(sql, data_dir)

    ctx = SessionContext(BallistaConfig({**QUERY_CONFIG, **extra_cfg}))
    register_tpch(ctx, data_dir)
    times, plan_times, run_launches, sorted_recs, stage_runs = [], [], [], [], []
    for i in range(4):  # one warm-up, then best of 3
        before = dict(ck.LAUNCHES)
        t0 = time.time()
        physical = maybe_compile_tpu(ctx.create_physical_plan(ctx.sql(sql).plan), ctx.config)
        plan_s = time.time() - t0
        tbl = ctx.execute_collect(physical)
        wall = time.time() - t0
        run_launches.append({k: ck.LAUNCHES[k] - before[k] for k in before})
        compare_answers(tbl, cpu_tbl, q)
        stages = [n for n in _walk(physical) if isinstance(n, (TpuStageExec, TpuFinalStageExec))]
        stage_runs.append(stages)
        partial = [s for s in stages if isinstance(s, TpuStageExec)]
        if not partial:
            raise AssertionError(f"q{q}: no device partial stage was planned")
        for s in stages:
            if s.tpu_count < 1 or s.fallback_count != 0:
                raise AssertionError(f"q{q}: {s.node_str()} did not run on the card "
                                     f"(device_runs={s.tpu_count}, fallbacks={s.fallback_count})")
        recs = RUN_STATS.stages()
        srt = [dict(recs[_tag(s)]) for s in partial if "n_seg" in recs.get(_tag(s), {})]
        if not srt:
            raise AssertionError(f"q{q}: no partial stage took the sorted aggregation")
        sorted_recs.append(srt)
        if i:
            times.append(wall)
            plan_times.append(plan_s)
        else:
            cold_wall = wall
    best = min(range(3), key=lambda k: times[k])
    warm = sorted_recs[best + 1]
    if q == 9 and not any("sorted" in r.get("build_modes", ()) for r in warm):
        raise AssertionError(f"q9: no sorted-mode join build ({[r.get('build_modes') for r in warm]})")
    if q == 21 and min(r["hash_probe"] for r in run_launches) < 1:
        raise AssertionError(f"q21: hash_probe launched {[r['hash_probe'] for r in run_launches]}"
                             " times per run, at least 1 expected")
    log(f"q{q}: equal to the CPU engine, {len(warm)} sorted stage(s) "
        f"(n_seg {[r['n_seg'] for r in warm]}, C {[r['seg_capacity'] for r in warm]}, "
        f"builds {[r.get('build_modes') for r in warm]}), launches per run "
        f"{[{k: v for k, v in r.items() if v} for r in run_launches]}")

    def one_run():
        physical = maybe_compile_tpu(ctx.create_physical_plan(ctx.sql(sql).plan), ctx.config)
        ctx.execute_collect(physical)

    t0 = time.time()
    by_name: dict = {}
    busy = device_busy_ms(one_run, by_name=by_name) if busy_ok else None
    traced_wall = time.time() - t0
    top_ops = sorted(([n[:80], ms, c] for n, (ms, c) in by_name.items()),
                     key=lambda r: -r[1])[:6]
    keep = ("n_seg", "seg_capacity", "live_rows", "sort_s", "fused_kernel_s", "exec_s",
            "build_s", "build_modes", "fusion_mode", "fusion_reason")
    if answers is not None:
        answers[q] = (tbl, cpu_tbl)
    return {
        "query": f"q{q}", "wall_s": times[best], "times_s": times, "plan_s": plan_times[best],
        "cold_wall_s": cold_wall, "rows_out": cpu_tbl.num_rows,
        "sorted_stages": [{k: r.get(k) for k in keep} for r in warm],
        "cold_sorted_stages": [{k: r.get(k) for k in keep} for r in sorted_recs[0]],
        "kernel_launches_per_run": run_launches, "cpu_engine_s": cpu_s,
        "device_nodes": _device_nodes(stage_runs[best + 1]),
        "traced_wall_s": traced_wall, "device_busy_ms": busy, "top_device_ops": top_ops,
        "device_idle_share": None if busy is None else 1.0 - busy / 1e3 / traced_wall,
    }


def _q21_large_session(data_dir: str, mode: str):
    from ballista_tpu_torch.client.context import SessionContext
    from ballista_tpu_torch.config import BallistaConfig
    from ballista_tpu_torch.testing.tpchgen import register_tpch

    # the semi and anti subqueries build over lineitem with a join filter
    # (60M rows at SF10): past the default collect budget of 16M rows they
    # become partitioned joins, which no device stage claims; at 2^26 rows
    # they collect, as they do at SF1
    ctx = SessionContext(BallistaConfig({**QUERY_CONFIG, "ballista.tpu.fusion.mode": mode,
                                         "ballista.tpu.broadcast.join.threshold.rows": 1 << 26}))
    register_tpch(ctx, data_dir)
    return ctx


def _q21_large_run(ctx):
    """One q21 run: its answer, wall, and its partial stages' RUN_STATS;
    every device stage on the card with no fallback."""
    from ballista_tpu_torch.engine.cuda_engine import maybe_compile_tpu
    from ballista_tpu_torch.ops.cuda.final_stage import TpuFinalStageExec
    from ballista_tpu_torch.ops.cuda.stage_compiler import RUN_STATS, TpuStageExec

    t0 = time.time()
    physical = maybe_compile_tpu(ctx.create_physical_plan(ctx.sql(_query_sql(21)).plan),
                                 ctx.config)
    tbl = ctx.execute_collect(physical)
    wall = time.time() - t0
    stages = [n for n in _walk(physical) if isinstance(n, (TpuStageExec, TpuFinalStageExec))]
    partial = [st for st in stages if isinstance(st, TpuStageExec)]
    if not partial:
        raise AssertionError("q21 large: no device partial stage was planned")
    for st in stages:
        if st.tpu_count < 1 or st.fallback_count != 0:
            raise AssertionError(f"q21 large: {st.node_str()} did not run on the card "
                                 f"(device_runs={st.tpu_count}, "
                                 f"fallbacks={st.fallback_count})")
    recs = RUN_STATS.stages()
    return tbl, wall, [dict(recs.get(_tag(st), {})) for st in partial]


def q21_large_reference(data_dir: str):
    """q21 at --scale under fused_xla on the card, cold: the answer
    q21_large_check holds fused_pallas to, and its wall. It runs while the
    engine=cpu answers are computed, before any timed cell, so the card's
    caches are dropped after it."""
    tbl, wall, _ = _q21_large_run(_q21_large_session(data_dir, "fused_xla"))
    _fresh_card()
    return tbl, wall


def q21_large_check(data_dir: str, scale: float, dev, busy_ok: bool, reference,
                    warm: int = 3) -> dict:
    """q21 at --scale (SF10: 100,000 suppliers, a 2^17-entry supplier
    table) under ballista.tpu.fusion.mode=fused_pallas, against the same
    query under fused_xla on the card (`reference`, q21_large_reference's),
    whose probes are plain gathers: the engine=cpu answer takes about 170 s
    at SF10, and q21's answer is counts and names, so the two must be equal
    exactly, rows and order. Both run with a device collect budget of 2^26
    build rows. The launch counts are set to 0 and fused_pallas runs cold,
    `warm` times warm (best of them) and once traced, each answer checked, every
    device stage on the card with no fallback, and the supplier probe
    launching hash_probe with its table in the regime hash_probe_regime
    picks for it, in every run."""
    from ballista_tpu_torch.ops.cuda import cuda_kernels as ck

    ref, ref_wall = reference
    ctx = _q21_large_session(data_dir, "fused_pallas")
    run = _q21_large_run
    T = 1 << int(10000 * scale).bit_length()  # the direct table over s_suppkey 1..10000 SF
    want = ck.hash_probe_regime(T, ck.hash_probe_smem_optin(dev))
    ck.reset_launches()
    walls, run_probes, stage_recs = [], [], []
    for i in range(1 + warm):  # cold, then best of `warm`
        before = dict(ck.HASH_PROBE_LAUNCHES.items())
        tbl, wall, recs = run(ctx)
        probes = {k: v - before.get(k, 0) for k, v in ck.HASH_PROBE_LAUNCHES.items()
                  if v != before.get(k, 0)}
        if not tbl.equals(ref):
            raise AssertionError(f"q21 large: run {i} under fused_pallas differs from fused_xla")
        if not any(k[2] == T and k[3:] == want for k in probes):
            raise AssertionError(f"q21 large: no hash_probe launch at T={T} in the {want} "
                                 f"regime in run {i}: {probes}")
        walls.append(wall)
        run_probes.append([[*k, v] for k, v in sorted(probes.items())])
        stage_recs.append(recs)
    best = min(range(1, 1 + warm), key=lambda k: walls[k])

    def one_run():
        run(ctx)

    t0 = time.time()
    by_name: dict = {}
    busy = device_busy_ms(one_run, by_name=by_name) if busy_ok else None
    traced_wall = time.time() - t0
    launches = dict(ck.LAUNCHES)
    top_ops = sorted(([n[:80], ms, c] for n, (ms, c) in by_name.items()),
                     key=lambda r: -r[1])[:6]
    keep = ("n_seg", "seg_capacity", "live_rows", "sort_s", "fused_kernel_s", "exec_s",
            "build_s", "build_modes", "fusion_mode", "fusion_reason", "device_bytes")
    log(f"q21 large: fused_pallas equal to fused_xla in every run (rows {ref.num_rows}), "
        f"cold {walls[0]:.2f}s, warm {walls[1:]}, hash_probe launches (P, N, T, regime, C, "
        f"count) per run {run_probes}")
    return {
        "query": "q21_large", "supplier_table": T, "wall_s": walls[best], "times_s": walls[1:],
        "cold_wall_s": walls[0], "fused_xla_cold_wall_s": ref_wall,
        "fused_xla_beside": "the engine=cpu oracle", "rows_out": ref.num_rows,
        "hash_probe_per_run": run_probes, "supplier_regime": list(want),
        "stages": [{k: r.get(k) for k in keep} for r in stage_recs[best]],
        "cold_stages": [{k: r.get(k) for k in keep} for r in stage_recs[0]],
        "traced_wall_s": traced_wall, "device_busy_ms": busy, "top_device_ops": top_ops,
        "device_idle_share": None if busy is None else 1.0 - busy / 1e3 / traced_wall,
        "launches": launches,
    }


def staged_check(data_dir: str) -> dict:
    """q1 under ballista.tpu.fusion.mode=staged on the card: byte-identical
    to the same query under fused_xla, with the per-span split recorded."""
    from ballista_tpu_torch.client.context import SessionContext
    from ballista_tpu_torch.config import BallistaConfig
    from ballista_tpu_torch.ops.cuda.stage_compiler import RUN_STATS
    from ballista_tpu_torch.testing.tpchgen import register_tpch

    with open(os.path.join(ROOT, "benchmarks", "tpch", "queries", "q1.sql")) as f:
        sql = f.read()
    out = {}
    for mode in ("fused_xla", "staged"):
        ctx = SessionContext(BallistaConfig({**QUERY_CONFIG, "ballista.tpu.fusion.mode": mode}))
        register_tpch(ctx, data_dir)
        RUN_STATS.clear()
        t0 = time.time()
        tbl = ctx.sql(sql).collect()
        out[mode] = (tbl, RUN_STATS.snapshot(), time.time() - t0)
    (fused, _, fused_s), (staged, stats, staged_s) = out["fused_xla"], out["staged"]
    if stats.get("fusion_mode") != "staged" or set(stats.get("span_s", {})) != {
            "predicate", "project", "aggregate"}:
        raise AssertionError(f"q1 staged: fusion_mode {stats.get('fusion_mode')!r}, "
                             f"span_s {stats.get('span_s')!r}")
    if not staged.equals(fused):
        raise AssertionError("q1 staged: the answer differs from fused_xla's")
    log(f"q1 staged: byte-identical to fused_xla, span_s {stats['span_s']}")
    return {"query": "q1_staged", "span_s": stats["span_s"],
            "fused_kernel_s": stats.get("fused_kernel_s"), "staged_wall_s": staged_s,
            "fused_xla_wall_s": fused_s}


def routing_check(data_dir: str, k: int = 16) -> dict:
    """One sorted stage (lineitem grouped by l_orderkey) under a hand-built
    hash-layout ShuffleWriterExec, as a distributed plan's first stage:
    the stage emits __pid on the card and the writer routes by it. Every
    written row must hash on the host, through ops/hashing, to its own
    partition, and the rows together must be the engine=cpu answer."""
    import shutil

    import numpy as np
    import pyarrow as pa
    import pyarrow.ipc as ipc

    from ballista_tpu_torch.client.context import SessionContext
    from ballista_tpu_torch.config import BallistaConfig
    from ballista_tpu_torch.engine.cuda_engine import maybe_compile_tpu
    from ballista_tpu_torch.ops.cuda.stage_compiler import TpuStageExec
    from ballista_tpu_torch.ops.hashing import partition_indices
    from ballista_tpu_torch.plan.physical import RepartitionExec, TaskContext
    from ballista_tpu_torch.shuffle.writer import ShuffleWriterExec
    from ballista_tpu_torch.testing.tpchgen import register_tpch

    sql = ("SELECT l_orderkey, sum(l_quantity) AS q, count(*) AS c FROM lineitem "
           "GROUP BY l_orderkey")
    ctx = SessionContext(BallistaConfig(dict(QUERY_CONFIG)))
    register_tpch(ctx, data_dir)
    phys = ctx.create_physical_plan(ctx.sql(sql).plan)
    rep = [n for n in _walk(phys) if isinstance(n, RepartitionExec) and n.scheme == "hash"][0]
    writer = ShuffleWriterExec(rep.input, "route", 1, k, rep.keys, sort_shuffle=False)
    compiled = maybe_compile_tpu(writer, ctx.config)
    stage = [n for n in _walk(compiled) if isinstance(n, TpuStageExec)][0]
    if stage.emit_pid != ([0], k):
        raise AssertionError(f"routing: emit_pid {stage.emit_pid!r}")
    work = os.path.join(ROOT, "build", "route_check")
    shutil.rmtree(work, ignore_errors=True)
    try:
        t0 = time.time()
        task = TaskContext(ctx.config, task_id="t0", work_dir=work)
        for p in range(compiled.output_partition_count()):
            list(compiled.execute(p, task))
        write_s = time.time() - t0
        if stage.pid_emitted < 1 or stage.fallback_count != 0 or stage.tpu_count < 1:
            raise AssertionError(f"routing: {stage.node_str()} pid_emitted={stage.pid_emitted}")
        tables = {}
        for pid_dir in sorted(os.listdir(os.path.join(work, "route", "1"))):
            parts = []
            for name in os.listdir(os.path.join(work, "route", "1", pid_dir)):
                if name.endswith(".arrow"):
                    with open(os.path.join(work, "route", "1", pid_dir, name), "rb") as fh:
                        parts.append(ipc.open_stream(fh).read_all())
            tables[int(pid_dir)] = pa.concat_tables(parts)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    for pid, t in tables.items():
        if "__pid" in t.column_names:
            raise AssertionError("routing: a written bucket kept the __pid column")
        host = partition_indices([t.column("l_orderkey").combine_chunks()], k)
        if not (host == pid).all():
            raise AssertionError(f"routing: {int((host != pid).sum())} rows of bucket {pid} "
                                 "hash elsewhere on the host")
    # the written partial rows (key, sum, count accumulators), one per group
    written = pa.concat_tables(tables.values()).sort_by("l_orderkey")
    cpu_ctx = SessionContext(BallistaConfig({"ballista.executor.engine": "cpu"}))
    register_tpch(cpu_ctx, data_dir)
    want = cpu_ctx.sql(sql).collect().sort_by("l_orderkey")
    if written.num_rows != want.num_rows or not written.column(0).equals(
            want.column(0)) or not written.column(2).equals(want.column(2)):
        raise AssertionError("routing: the written rows are not the engine=cpu answer")
    if not np.allclose(written.column(1).to_numpy(), want.column(1).to_numpy(),
                       rtol=1e-9, atol=0.0):
        raise AssertionError("routing: the written sums differ from the engine=cpu answer")
    log(f"routing: {written.num_rows} groups in {len(tables)} of {k} buckets, every row "
        f"hashes on the host to its own bucket, equal to the engine=cpu answer")
    return {"query": "route_l_orderkey", "groups": written.num_rows, "buckets": len(tables),
            "k": k, "write_s": write_s, "pid_emitted": stage.pid_emitted}


# ---------------------------------------------------------------- out of core

def _ooc_run(data_dir: str, q: int, cfg: dict):
    """One run of TPC-H q`q` through SessionContext with engine=tpu and
    `cfg`: (answer, the partial stages' records, every device stage, wall s)."""
    from ballista_tpu_torch.client.context import SessionContext
    from ballista_tpu_torch.config import BallistaConfig
    from ballista_tpu_torch.engine.cuda_engine import maybe_compile_tpu
    from ballista_tpu_torch.ops.cuda.final_stage import TpuFinalStageExec
    from ballista_tpu_torch.ops.cuda.stage_compiler import RUN_STATS, TpuStageExec
    from ballista_tpu_torch.testing.tpchgen import register_tpch

    with open(os.path.join(ROOT, "benchmarks", "tpch", "queries", f"q{q}.sql")) as f:
        sql = f.read()
    ctx = SessionContext(BallistaConfig(cfg))
    register_tpch(ctx, data_dir)
    t0 = time.time()
    physical = maybe_compile_tpu(ctx.create_physical_plan(ctx.sql(sql).plan), ctx.config)
    tbl = ctx.execute_collect(physical)
    wall = time.time() - t0
    stages = [n for n in _walk(physical) if isinstance(n, (TpuStageExec, TpuFinalStageExec))]
    recs = RUN_STATS.stages()
    partial = [s for s in stages if isinstance(s, TpuStageExec)]
    if not partial:
        raise AssertionError(f"q{q}: no device partial stage was planned")
    for s in stages:
        if s.tpu_count < 1 or s.fallback_count != 0:
            raise AssertionError(f"q{q}: {s.node_str()} did not run on the card "
                                 f"(device_runs={s.tpu_count}, fallbacks={s.fallback_count})")
    return tbl, [dict(recs.get(_tag(s), {})) for s in partial], partial, wall


def _fresh_card() -> None:
    """Drop every cached table, build, LUT and spilled table, and hand the
    allocator's cached blocks back to the card."""
    import torch

    from ballista_tpu_torch.ops.cuda.stage_compiler import RUN_STATS, clear_device_caches

    clear_device_caches()
    RUN_STATS.clear()
    torch.cuda.empty_cache()


def _digest(dt) -> list:
    """Per plane of a device table (columns, row mask, validity planes, None
    slots kept): dtype, shape and the CRC-32 of its bytes."""
    import zlib

    import numpy as np

    out = []
    for t in list(dt.cols) + [dt.mask] + list(dt.valids):
        if t is None:
            out.append(None)
            continue
        a = np.ascontiguousarray(t.cpu().numpy()).reshape(-1).view(np.uint8)
        out.append((str(t.dtype), tuple(t.shape), zlib.crc32(a)))
    return out


def _grace_rec(recs: list, q: str) -> dict:
    got = [r for r in recs if r.get("hbm_plan") == "grace_split"]
    if len(got) != 1:
        raise AssertionError(f"{q}: {len(got)} grace-split stages, expected 1: "
                             f"{[r.get('hbm_plan_reason') for r in recs]}")
    return got[0]


def _working_set(reason: str) -> int:
    import re

    m = re.search(r"working set (\d+) B", reason or "")
    if m is None:
        raise AssertionError(f"no working set in the admission reason {reason!r}")
    return int(m.group(1))


def spill_touch_check(data_dir: str, tier: str, ref: dict, dev) -> dict:
    """q1, then q6, then q1 again under a device budget that holds either
    lineitem table but not both: q6's fill demotes q1's table to the spill
    pool (`tier` "host": host buffers; "disk": npz files, the host tier cut
    to 1 byte), and the second q1 restores it with no encode. Each answer
    equals `ref`'s device answer exactly; the restored planes equal the
    spilled ones (CRC-32 per plane); the disk tier leaves no .tmp file.
    `ref` maps 1 and 6 to (answer, device bytes)."""
    import shutil

    from ballista_tpu_torch.ops.cuda import hbm
    from ballista_tpu_torch.ops.cuda import stage_compiler as sc

    b1, b6 = ref[1][1], ref[6][1]
    spill_dir = os.path.join(ROOT, "build", "hbm_spill")
    shutil.rmtree(spill_dir, ignore_errors=True)
    cfg = {**SPILL_CONFIG, "ballista.tpu.hbm.budget.bytes": max(b1, b6) + min(b1, b6) // 2,
           "ballista.tpu.hbm.spill.host.bytes": 2 * max(b1, b6) if tier == "host" else 1,
           "ballista.tpu.hbm.spill.dir": spill_dir}

    def files():
        names = os.listdir(spill_dir) if os.path.isdir(spill_dir) else []
        if any(n.endswith(".tmp") for n in names):
            raise AssertionError(f"spill {tier}: a .tmp file was left behind: {names}")
        return [n for n in names if n.endswith(".npz")]

    spills = []
    orig = sc._spill_device_table

    def timed_spill(pool, key, dt):
        t0 = time.time()
        orig(pool, key, dt)
        spills.append((dt.nbytes, time.time() - t0))

    _fresh_card()
    sc._spill_device_table = timed_spill
    try:
        st0 = hbm.SPILL_POOL.stats()
        t1, r1, s1, w1 = _ooc_run(data_dir, 1, cfg)
        q1_scan = s1[0].scan
        before = _digest(sc.DEVICE_CACHE.peek(q1_scan, dev))
        t6, r6, _s6, w6 = _ooc_run(data_dir, 6, cfg)
        st6 = hbm.SPILL_POOL.stats()
        if sc.DEVICE_CACHE.peek(q1_scan, dev) is not None or not spills or spills[0][0] != b1:
            raise AssertionError(f"spill {tier}: q6's fill did not demote q1's table "
                                 f"({spills}, {st6})")
        if tier == "disk" and len(files()) != 1:
            raise AssertionError(f"spill disk: {files()} after q1's demotion")
        t1b, r1b, _s1b, w1b = _ooc_run(data_dir, 1, cfg)
        st1 = hbm.SPILL_POOL.stats()
        after = _digest(sc.DEVICE_CACHE.peek(q1_scan, dev))
    finally:
        sc._spill_device_table = orig
    if st1["reupload_events"] != st0["reupload_events"] + 1 or "encode_s" in r1b[0]:
        raise AssertionError(f"spill {tier}: q1 was not restored from the pool ({st1}, {r1b[0]})")
    if after != before:
        raise AssertionError(f"spill {tier}: the restored planes differ from the spilled ones")
    for name, got, want in (("q1", t1, ref[1][0]), ("q6", t6, ref[6][0]), ("q1 restored", t1b,
                                                                           ref[1][0])):
        if not got.equals(want):
            raise AssertionError(f"spill {tier}: {name}'s answer differs from the reference run")
    n_files = len(files()) if tier == "disk" else None  # q6's table, demoted by q1's restore
    if tier == "disk" and n_files != 1:
        raise AssertionError(f"spill disk: {n_files} npz files after the restore, expected 1")
    log(f"spill {tier}: q1 ({b1} B) spilled in {spills[0][1]:.3f}s and restored bitwise in "
        f"fill_s {r1b[0].get('fill_s')} (cold fill_s {r1[0].get('fill_s')}); answers exact")
    return {"query": f"spill_touch_{tier}", "q1_bytes": b1, "q6_bytes": b6,
            "budget_bytes": cfg["ballista.tpu.hbm.budget.bytes"],
            "spills": [{"bytes": b, "spill_s": t} for b, t in spills],
            "spill_bytes": st1["spill_bytes"] - st0["spill_bytes"],
            "spill_events": st1["spill_events"] - st0["spill_events"],
            "reupload_events": st1["reupload_events"] - st0["reupload_events"],
            "cold_fill_s": r1[0].get("fill_s"), "cold_encode_s": r1[0].get("encode_s"),
            "reupload_fill_s": r1b[0].get("fill_s"), "q6_plan": r6[0].get("hbm_plan"),
            "walls_s": {"q1_cold": w1, "q6": w6, "q1_restored": w1b}, "npz_files_after": n_files,
            "digest_planes": len(before)}


def grace_q5_check(data_dir: str, whole_rec: dict, answers: tuple, busy_ok: bool) -> dict:
    """q5 in auto mode under a budget of its working set (the local run's
    admission reason) less 1 byte: a grace split into 4 sub-buckets at depth
    1, one cold run, best of 3 warm, one traced. Every answer equals the
    local run's device and engine=cpu answers (strings and ints exact,
    revenue within rtol 1e-9), every stage on the card, and every run
    launches hash_probe twice (nation, region) per sub-run."""
    from ballista_tpu_torch.ops.cuda import cuda_kernels as ck

    ws = _working_set(whole_rec["hbm_plan_reason"])
    cfg = {**SPILL_CONFIG, "ballista.tpu.hbm.budget.bytes": ws - 1}
    _fresh_card()
    dev_tbl, cpu_tbl = answers
    times, run_launches, recs = [], [], []
    for i in range(4):  # cold, then best of 3
        ck.reset_launches()
        tbl, prs, _stages, wall = _ooc_run(data_dir, 5, cfg)
        run_launches.append(dict(ck.LAUNCHES))
        rec = _grace_rec(prs, "q5 grace")
        if "into 4 sub-buckets (depth 1)" not in rec["hbm_plan_reason"] or \
                rec.get("grace_splits") != 4:
            raise AssertionError(f"q5 grace: {rec.get('grace_splits')} sub-runs, "
                                 f"{rec['hbm_plan_reason']!r}")
        if run_launches[-1]["hash_probe"] < 2 * rec["grace_splits"]:
            raise AssertionError(f"q5 grace: hash_probe launched {run_launches[-1]['hash_probe']}"
                                 f" times over {rec['grace_splits']} sub-runs")
        compare_answers(tbl, dev_tbl, 5)
        compare_answers(tbl, cpu_tbl, 5)
        recs.append(rec)
        if i:
            times.append(wall)
        else:
            cold_wall = wall

    def one_run():
        _ooc_run(data_dir, 5, cfg)

    t0 = time.time()
    ck.reset_launches()
    by_name: dict = {}
    busy = device_busy_ms(one_run, by_name=by_name) if busy_ok else None
    traced_wall = time.time() - t0
    traced_launches = dict(ck.LAUNCHES)
    top_ops = sorted(([n[:80], ms, c] for n, (ms, c) in by_name.items()),
                     key=lambda r: -r[1])[:6]
    best = min(range(3), key=lambda k: times[k])
    warm = recs[best + 1]
    log(f"q5 grace: 4 sub-runs, answers equal to the local run's and the CPU engine's; cold "
        f"{cold_wall:.2f}s, warm {times}, hash_probe per run "
        f"{[r['hash_probe'] for r in run_launches]}")
    keep = ("fill_s", "build_s", "exec_s", "fused_kernel_s", "grace_splits", "hbm_plan",
            "hbm_plan_reason", "hbm_budget_bytes", "fusion_mode")
    return {"query": "q5_grace", "working_set_bytes": ws, "wall_s": times[best], "times_s": times,
            "cold_wall_s": cold_wall, "cold": {k: recs[0].get(k) for k in keep},
            "warm": {k: warm.get(k) for k in keep},
            "kernel_launches_per_run": run_launches, "traced_launches": traced_launches,
            "launches": {k: sum(r[k] for r in run_launches) + traced_launches[k]
                         for k in traced_launches},
            "traced_wall_s": traced_wall, "device_busy_ms": busy, "top_device_ops": top_ops,
            "device_idle_share": None if busy is None else 1.0 - busy / 1e3 / traced_wall}


def grace_depth2_check(data_dir: str) -> dict:
    """q5 at a budget between fixed + split/16 and fixed + split/4 (fixed and
    split read from the admission reasons of a whole run and of a run one
    byte over): 16 sub-buckets at depth 2, each answer equal to the whole
    run's (floats within rtol 1e-9), hash_probe in every sub-run."""
    import re

    from ballista_tpu_torch.ops.cuda import cuda_kernels as ck

    _fresh_card()
    whole, prs, _st, w_whole = _ooc_run(data_dir, 5, SPILL_CONFIG)
    ws = _working_set(prs[0]["hbm_plan_reason"])
    out = {"query": "q5_grace_depth2", "working_set_bytes": ws, "whole_wall_s": w_whole}
    budgets = {4: ws - 1}
    for n in (4, 16):
        _fresh_card()
        ck.reset_launches()
        tbl, prs, _st, wall = _ooc_run(
            data_dir, 5, {**SPILL_CONFIG, "ballista.tpu.hbm.budget.bytes": budgets[n]})
        rec = _grace_rec(prs, f"q5 grace {n}")
        depth = 1 if n == 4 else 2
        if f"into {n} sub-buckets (depth {depth})" not in rec["hbm_plan_reason"] or \
                rec.get("grace_splits") != n or ck.LAUNCHES["hash_probe"] < 2 * n:
            raise AssertionError(f"q5 grace {n}: {rec.get('grace_splits')} sub-runs, hash_probe "
                                 f"{ck.LAUNCHES['hash_probe']}, {rec['hbm_plan_reason']!r}")
        compare_answers(tbl, whole, 5)
        if n == 4:
            split = int(re.search(r"grace-splitting build \d+ \((\d+) B\)",
                                  rec["hbm_plan_reason"]).group(1))
            fixed = ws - split
            budgets[16] = fixed + (-(-split // 16) + -(-split // 4)) // 2
            out.update(split_bytes=split, fixed_bytes=fixed)
        out[f"grace{n}"] = {"budget_bytes": budgets[n], "cold_wall_s": wall,
                            "grace_splits": rec["grace_splits"],
                            "hash_probe": ck.LAUNCHES["hash_probe"],
                            "exec_s": rec.get("exec_s"), "build_s": rec.get("build_s")}
    log(f"q5 grace depth 2: 16 sub-runs, equal to the whole run (budget {budgets[16]} B)")
    return out


class _Warnings:
    """Collect the stage compiler's warnings (the OOM rung's)."""

    def __enter__(self):
        import logging

        self.records = []
        self.logger = logging.getLogger("ballista_tpu_torch.ops.cuda.stage_compiler")
        self.handler = logging.Handler(logging.WARNING)
        self.handler.emit = lambda r: self.records.append(r.getMessage())
        self.logger.addHandler(self.handler)
        return self.records

    def __exit__(self, *exc):
        self.logger.removeHandler(self.handler)


def oom_injected_check(data_dir: str, answer, dev) -> dict:
    """q3 with hbm_oom chaos armed (budget 1 TiB, the first upload raises
    RESOURCE_EXHAUSTED once): the stage spills, retries once (pre-planned
    as a grace split) and answers as phase 6 did (floats within rtol 1e-9).
    Also measures the retry's peak device memory, which sizes the real-OOM
    check's margin."""
    from ballista_tpu_torch.ops.cuda import hbm

    _fresh_card()
    retries0 = hbm.oom_retry_count()
    hbm.arm_chaos(1 << 40, oom_n=1)
    try:
        with _Warnings() as warned:
            (tbl, prs, _st, wall), peak = _peak_run(data_dir, 3, SPILL_CONFIG, dev)
    finally:
        hbm.disarm_chaos()
    rec = max(prs, key=lambda r: r.get("device_bytes") or 0)
    if hbm.oom_retry_count() != retries0 + 1 or rec.get("hbm_oom_retries", 0) < 1 or \
            not any("InjectedResourceExhausted" in w for w in warned):
        raise AssertionError(f"oom injected: no spill-and-retry ({rec}, {warned})")
    compare_answers(tbl, answer, 3)
    log(f"oom injected: q3 retried once ({rec.get('hbm_plan')}, grace_splits "
        f"{rec.get('grace_splits')}), equal to phase 6; peak {peak} B")
    return {"query": "oom_injected_q3", "wall_s": wall, "hbm_plan": rec.get("hbm_plan"),
            "hbm_plan_reason": rec.get("hbm_plan_reason"), "grace_splits": rec.get("grace_splits"),
            "hbm_oom_retries": rec.get("hbm_oom_retries"), "peak_allocated_bytes": peak,
            "q3_table_bytes": rec.get("device_bytes")}


def _peak_run(data_dir: str, q: int, cfg: dict, dev):
    """_ooc_run with the device memory it allocated at its peak above what
    was allocated before it."""
    import torch

    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    out = _ooc_run(data_dir, q, cfg)
    return out, torch.cuda.max_memory_allocated(dev) - base


def oom_real_check(data_dir: str, answer, dev, first_need: int, retry_need: int,
                   q3_bytes: int, q16_bytes: int) -> dict:
    """A real torch.cuda.OutOfMemoryError: q1's and q6's tables resident (no
    budget; `q16_bytes` between them), one blocker tensor holds the card's
    free memory less a margin, and q3 runs. The margin lies between what
    the retry needs once the residents are spilled (`retry_need`, the
    injected check's peak, for the retry is pre-planned as a grace split,
    less the residents) and the whole first attempt's peak (`first_need`,
    a cold q3 run's): so the first attempt runs out of memory, the spill
    of the residents makes room, and the retry answers as phase 6 did. The
    blocker is freed in `finally`."""
    import torch

    from ballista_tpu_torch.ops.cuda import hbm
    from ballista_tpu_torch.ops.cuda import stage_compiler as sc

    _ooc_run(data_dir, 1, SPILL_CONFIG)  # both from the cache or the spill pool
    _ooc_run(data_dir, 6, SPILL_CONFIG)
    resident = sc.DEVICE_CACHE.resident_bytes()
    if resident != q16_bytes:
        raise AssertionError(f"oom real: {resident} B resident, expected q1's and q6's "
                             f"{q16_bytes} B")
    lo, hi = retry_need - resident, first_need
    if hi - lo < 256 << 20:
        raise AssertionError(f"oom real: no room for a margin: the retry needs {retry_need} B, "
                             f"the residents hold {resident} B, the first attempt {first_need} B")
    margin = (max(lo, 0) + hi) // 2
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info(dev)
    log(f"oom real: first attempt needs {first_need} B, the retry {retry_need} B, residents "
        f"{resident} B, q3's table {q3_bytes} B, free {free} of {total} B: margin {margin} B")
    spilled0 = hbm.SPILL_POOL.stats()
    retries0 = hbm.oom_retry_count()
    blocker = torch.empty(free - margin, dtype=torch.uint8, device=dev)
    try:
        with _Warnings() as warned:
            tbl, prs, _st, wall = _ooc_run(data_dir, 3, SPILL_CONFIG)
    finally:
        del blocker
        torch.cuda.empty_cache()
    spilled = hbm.SPILL_POOL.stats()
    rec = max(prs, key=lambda r: r.get("device_bytes") or 0)
    if hbm.oom_retry_count() != retries0 + 1 or \
            not any("OutOfMemoryError" in w for w in warned):
        raise AssertionError(f"oom real: no real out-of-memory retry ({warned})")
    if spilled["spill_bytes"] - spilled0["spill_bytes"] < resident:
        raise AssertionError(f"oom real: the rung spilled {spilled}, not the residents")
    compare_answers(tbl, answer, 3)
    log(f"oom real: q3 ran out of memory, spilled "
        f"{spilled['spill_bytes'] - spilled0['spill_bytes']} B and retried "
        f"({rec.get('hbm_plan')}), equal to phase 6")
    return {"query": "oom_real_q3", "wall_s": wall, "first_need_bytes": first_need,
            "retry_need_bytes": retry_need, "margin_bytes": margin, "resident_bytes": resident,
            "q3_table_bytes": q3_bytes, "free_bytes": free, "total_bytes": total,
            "spilled_bytes": spilled["spill_bytes"] - spilled0["spill_bytes"],
            "hbm_plan": rec.get("hbm_plan"), "grace_splits": rec.get("grace_splits"),
            "hbm_oom_retries": rec.get("hbm_oom_retries"), "warning": warned[:1]}


def out_of_core_phase(big_dir: str, q4_dir: str, dev, busy_ok: bool, recs: dict,
                      answers: dict, small_recs: dict, small_answers: dict) -> list[dict]:
    """Phase 7, the out-of-core rungs: the injected and the real
    out-of-memory retry on q3 and the spill round trip on q1/q6 through the
    host tier (at --scale), then the grace split of q5, grace at depth 2
    and the disk tier at --q4-scale. Chaos is disarmed, the blocker freed
    and the caches cleared whatever happens."""
    from ballista_tpu_torch.ops.cuda import hbm

    out = []
    try:
        inj = oom_injected_check(big_dir, answers[3][0], dev)
        out.append(inj)
        # the whole first attempt's peak, which with (a)'s sizes the real
        # OOM's margin
        _fresh_card()
        (_t, prs, _s, _w), first_need = _peak_run(big_dir, 3, SPILL_CONFIG, dev)
        # the host round trip leaves q1's table resident and q6's spilled:
        # the real OOM check restores q6 beside it
        out.append(spill_touch_check(
            big_dir, "host", {q: (answers[q][0], recs[q]["device_bytes"]) for q in (1, 6)}, dev))
        out.append(oom_real_check(
            big_dir, answers[3][0], dev, first_need, inj["peak_allocated_bytes"],
            max(r.get("device_bytes") or 0 for r in prs),
            recs[1]["device_bytes"] + recs[6]["device_bytes"]))
        out.append(grace_q5_check(q4_dir, small_recs[5], small_answers[5], busy_ok))
        out.append(grace_depth2_check(q4_dir))
        _fresh_card()
        small = {}
        for q in (1, 6):
            tbl, prs, _st, _w = _ooc_run(q4_dir, q, QUERY_CONFIG)
            small[q] = (tbl, prs[0]["device_bytes"])
        out.append(spill_touch_check(q4_dir, "disk", small, dev))
    finally:
        hbm.disarm_chaos()
        _fresh_card()
    return out


def _probe_launches() -> list:
    """hash_probe's launches since the counts were last set to 0, as
    [P, N, T, regime, cluster size, launches] rows."""
    from ballista_tpu_torch.ops.cuda import cuda_kernels as ck

    return [[*k, v] for k, v in sorted(ck.HASH_PROBE_LAUNCHES.items())]


def _filter_launches() -> list:
    """dict_filter's launches since the counts were last set to 0, as
    [P, N, T, regime, masked, launches] rows."""
    from ballista_tpu_torch.ops.cuda import cuda_kernels as ck

    return [[*k, v] for k, v in sorted(ck.DICT_FILTER_LAUNCHES.items())]


def _device_nodes(stages) -> dict:
    """{node kind: [nodes, device passes]} of one local run's device stages."""
    out: dict = {}
    for s in stages:
        d = out.setdefault(type(s).__name__, [0, 0])
        d[0] += 1
        d[1] += s.tpu_count
    return out


def _tag(stage) -> str:
    import zlib

    return f"stage_{zlib.crc32(stage.fingerprint.encode()):08x}"


# ---------------------------------------------------------------- standalone

# phase 8: (query, data, config) through SessionContext.standalone(...,
# num_executors=1, vcores=4); "big" is --scale, "small" --q4-scale, as the
# same query's local run in phase 4 or 6; the kernel every run must launch.
# q1 and q3, which launch no kernel, left this phase for the run's time
# limit (PERF.md, PR 10 run R4): phase 9 runs q1, and q3 runs here over
# Flight, through the same scheduler and executor code.
STANDALONE_QUERIES = (
    (6, "big", {}, None), (5, "small", {}, "hash_probe"),
    (12, "small", {"ballista.tpu.fusion.mode": "fused_pallas"}, "dict_filter"),
    (4, "small", {}, "masked_group_reduce"),
)


def _drive_cluster(ctx, scheduler_of, q: int, label: str, dev, busy_ok: bool,
                   local_rec: dict, local_tbl, flight_servers=(), rpc=None,
                   force_remote: bool = False, warm_runs: int = 3, kernel: str | None = None,
                   rtol: float = 1e-9) -> dict:
    """One query through a cluster (`scheduler_of()`: its SchedulerServer,
    in this process): a cold run and best of `warm_runs`, each answer equal
    to the port's local answer on the card (PERF.md §2's rule; floats
    within `rtol`); every device stage on the card in every task with no
    fallback, holding every device node kind local mode ran; `kernel`,
    where given, launched in every run;
    one traced warm run. Per stage: tasks, device passes summed over them,
    shuffle bytes written and read; the Flight servers' RPCs and bytes; the
    scheduler's gRPC launches and status updates (`rpc`); kernel launches
    per run; peak device bytes and the admission plans."""
    import torch

    from ballista_tpu_torch.ops.cuda import cuda_kernels as ck
    from ballista_tpu_torch.ops.cuda.stage_compiler import RUN_STATS
    from ballista_tpu_torch.testing.standalone_stats import last_job, stage_stats

    with open(os.path.join(ROOT, "benchmarks", "tpch", "queries", f"q{q}.sql")) as f:
        sql = f.read()
    RUN_STATS.clear()
    torch.cuda.reset_peak_memory_stats(dev)
    walls, run_launches, flight, rpcs, stats_runs = [], [], [], [], []
    flight_keys = ("do_get", "coalesced_rpc", "block_rpc", "bytes_served")
    for _ in range(1 + warm_runs):
        before = dict(ck.LAUNCHES)
        served = [dict(s.stats) for s in flight_servers]
        sent = rpc.snapshot() if rpc is not None else {}
        t0 = time.time()
        tbl = ctx.sql(sql).collect()
        walls.append(time.time() - t0)
        run_launches.append({k: ck.LAUNCHES[k] - before[k] for k in before})
        flight.append({k: sum(s.stats[k] - b[k] for s, b in zip(flight_servers, served))
                       for k in flight_keys})
        if rpc is not None:
            rpcs.append({k: v - sent[k] for k, v in rpc.snapshot().items()})
        compare_answers(tbl, local_tbl, q, rtol)
        stats_runs.append(stage_stats(last_job(scheduler_of())))
        if kernel is not None and run_launches[-1][kernel] < 1:
            raise AssertionError(f"q{q} {label}: a run launched no {kernel}")
    peak = torch.cuda.max_memory_allocated(dev)
    plans = {tag: {k: r.get(k) for k in ("hbm_plan", "grace_splits", "hbm_oom_retries")}
             for tag, r in RUN_STATS.stages().items() if "hbm_plan" in r}
    kinds: dict = {}
    for stats in stats_runs:
        for sid, st in stats.items():
            if st["fallbacks"]:
                raise AssertionError(f"q{q} {label}: stage {sid} fell back to the "
                                     f"CPU engine ({st['device']})")
            for kind, (nodes, passes, _fb) in st["device"].items():
                if not passes == nodes == st["tasks"]:
                    raise AssertionError(f"q{q} {label}: stage {sid}: {nodes} {kind} "
                                         f"ran {passes} device passes in {st['tasks']} tasks")
                kinds[kind] = kinds.get(kind, 0) + nodes
    missing = sorted(set(local_rec["device_nodes"]) - set(kinds))
    if missing:
        raise AssertionError(f"q{q} {label}: no stage ran {missing} on the card, "
                             "as local mode does")
    if force_remote:
        stats = stats_runs[-1]
        if (sum(st["bytes_read_local"] for st in stats.values())
                or not sum(st["bytes_fetched_remote"] for st in stats.values())):
            raise AssertionError(f"q{q} {label}: a shuffle read did not go over Flight")
    busy = traced_wall = None
    if busy_ok and warm_runs:
        t0 = time.time()
        busy = device_busy_ms(lambda: ctx.sql(sql).collect())
        traced_wall = time.time() - t0
    warm = walls[1:]
    best = min(range(len(warm)), key=lambda k: warm[k]) + 1 if warm else 0
    stats = stats_runs[best]
    return {
        "query": f"{label}_q{q}" + ("_flight" if force_remote else ""),
        "cold_wall_s": walls[0], "wall_s": walls[best], "times_s": warm,
        "local_wall_s": local_rec["wall_s"], "local_cold_wall_s": local_rec["cold_wall_s"],
        "stages": len(stats),
        "tasks_per_stage": {sid: st["tasks"] for sid, st in stats.items()},
        "device_passes_per_stage": {sid: st["device_passes"] for sid, st in stats.items()},
        "device_nodes_per_stage": {sid: st["device"] for sid, st in stats.items() if st["device"]},
        "local_device_nodes": local_rec["device_nodes"],
        "fallbacks": sum(st["fallbacks"] for st in stats.values()),
        "shuffle_bytes_written": sum(st["shuffle_bytes_written"] for st in stats.values()),
        "shuffle_bytes_read_local": sum(st["bytes_read_local"] for st in stats.values()),
        "shuffle_bytes_fetched_remote": sum(st["bytes_fetched_remote"] for st in stats.values()),
        "reader_fetch_rpcs": sum(st["fetch_rpcs"] for st in stats.values()),
        "flight_per_run": flight,
        **({"grpc_per_run": rpcs} if rpc is not None else {}),
        "kernel_launches_per_run": run_launches,
        "local_kernel_launches_per_run": local_rec["kernel_launches_per_run"][-1],
        "device_busy_ms": busy, "traced_wall_s": traced_wall,
        "device_idle_share": None if busy is None else 1.0 - busy / 1e3 / traced_wall,
        "local_device_busy_ms": local_rec["device_busy_ms"],
        "local_device_idle_share": local_rec["device_idle_share"],
        "peak_device_bytes": peak, "hbm_plan": plans,
    }


def run_standalone_query(q: int, data_dir: str, extra_cfg: dict, dev, busy_ok: bool,
                         local_rec: dict, local_tbl, num_executors: int = 1,
                         force_remote: bool = False, warm_runs: int = 3,
                         kernel: str | None = None) -> dict:
    """One query through SessionContext.standalone(num_executors, vcores=4)
    (_drive_cluster says what is checked and recorded)."""
    from ballista_tpu_torch.client.context import SessionContext
    from ballista_tpu_torch.config import BallistaConfig
    from ballista_tpu_torch.testing.tpchgen import register_tpch

    cfg = {**QUERY_CONFIG, **extra_cfg}
    if force_remote:
        cfg["ballista.shuffle.reader.force_remote_read"] = True
    ctx = SessionContext.standalone(BallistaConfig(cfg), num_executors=num_executors, vcores=4)
    try:
        register_tpch(ctx, data_dir)
        cluster = ctx._ensure_cluster()
        r = _drive_cluster(ctx, lambda: cluster.scheduler, q, "standalone", dev, busy_ok,
                           local_rec, local_tbl, flight_servers=[cluster.flight_server],
                           force_remote=force_remote, warm_runs=warm_runs, kernel=kernel)
    finally:
        ctx.shutdown()
    return {**r, "num_executors": num_executors, "vcores": 4, "config": extra_cfg}


# ---------------------------------------------------------------- remote

# phase 9 (a): (query, data, config, the kernel every run must launch)
# through SessionContext.remote against an in-process scheduler daemon and
# one executor pinned to card 0 (one slot). q1, q5 and q12 run on the small
# data (--q4-scale), held to local runs at that scale, to leave the run's
# time limit room for phase 10 (PERF.md §4)
REMOTE_QUERIES = (
    (1, "small", {}, None), (6, "big", {}, None), (5, "small", {}, "hash_probe"),
    (12, "small", {"ballista.tpu.fusion.mode": "fused_pallas"}, "dict_filter"),
    (4, "small", {}, "masked_group_reduce"),
)
# One slot serializes the CPU join stages of q5 and q12 (warm runs of 6-26 s
# at SF10, PR 10): reached past LATE_AT["remote"], they keep one warm run.
REMOTE_SLOW = (5, 12)
REMOTE_DIR = os.path.join(ROOT, "build", "remote")  # executors' work dirs, daemon logs
DAEMON_DEADLINE_S = 120.0


class RpcCounts:
    """The scheduler's gRPC task traffic: LaunchMultiTask calls and the
    tasks they carry (push mode), tasks handed out in PollWork replies (pull
    mode), and the RPCs that brought task statuses (UpdateTaskStatus, or a
    PollWork carrying statuses) with the statuses they carried."""

    def __init__(self, server):
        import threading

        self._lock = threading.Lock()
        self.counts = dict.fromkeys(("launch_rpcs", "launched_tasks", "polled_tasks",
                                     "status_updates", "task_statuses"), 0)
        launch, update, poll = server.launcher.launch, server.update_task_status, server.poll_work

        def counted_launch(executor_id, tasks, srv):
            self._add(launch_rpcs=1, launched_tasks=len(tasks))
            return launch(executor_id, tasks, srv)

        def counted_update(executor_id, results):
            if results:
                self._add(status_updates=1, task_statuses=len(results))
            return update(executor_id, results)

        def counted_poll(metadata, can_accept, free_slots, results):
            out = poll(metadata, can_accept, free_slots, results)
            self._add(polled_tasks=len(out), status_updates=int(bool(results)),
                      task_statuses=len(results))
            return out

        server.launcher.launch = counted_launch
        server.update_task_status = counted_update
        server.poll_work = counted_poll

    def _add(self, **kw) -> None:
        with self._lock:
            for k, v in kw.items():
                self.counts[k] += v

    def snapshot(self) -> dict:
        with self._lock:
            return dict(self.counts)


def start_remote_cluster(pull: bool = False):
    """An in-process scheduler daemon on 127.0.0.1 (REST and the Flight
    result proxy on) and one push executor at engine=tpu pinned to card 0,
    each on real sockets; with `pull`, a second executor in pull mode,
    pinned to the same card. Returns (scheduler, address, executors, rpc)."""
    import shutil

    from ballista_tpu_torch.executor.executor_process import ExecutorProcess
    from ballista_tpu_torch.scheduler.process import SchedulerProcess

    sched = SchedulerProcess(bind_host="127.0.0.1", port=0, rest_port=0)
    sched.start()
    rpc = RpcCounts(sched.scheduler)
    addr = f"127.0.0.1:{sched.port}"
    execs = []
    try:
        for policy in ("push", "pull") if pull else ("push",):
            work = os.path.join(REMOTE_DIR, f"inproc_{policy}")
            shutil.rmtree(work, ignore_errors=True)
            ex = ExecutorProcess(addr, bind_host="127.0.0.1", external_host="127.0.0.1",
                                 engine="tpu", device_ordinal=0, policy=policy, work_dir=work)
            execs.append(ex)
            ex.start()
    except BaseException:
        stop_remote_cluster(sched, execs)
        raise
    return sched, addr, execs, rpc


def stop_remote_cluster(sched, execs) -> None:
    import shutil

    for ex in execs:
        ex.shutdown()
        shutil.rmtree(ex.work_dir, ignore_errors=True)
    sched.shutdown()


def run_remote_query(q: int, data_dir: str, extra_cfg: dict, kernel: str | None, dev,
                     busy_ok: bool, local_rec: dict, local_tbl, cluster,
                     force_remote: bool = False, warm_runs: int = 3,
                     rtol: float = 1e-9) -> dict:
    """One query through SessionContext.remote(addr) against `cluster`
    (start_remote_cluster; _drive_cluster says what is checked and
    recorded), with the data plane each executor served from."""
    from ballista_tpu_torch.client.context import SessionContext
    from ballista_tpu_torch.config import BallistaConfig
    from ballista_tpu_torch.testing.tpchgen import register_tpch

    sched, addr, execs, rpc = cluster
    cfg = {**QUERY_CONFIG, **extra_cfg}
    if force_remote:
        cfg["ballista.shuffle.reader.force_remote_read"] = True
    ctx = SessionContext.remote(addr, BallistaConfig(cfg))
    register_tpch(ctx, data_dir)
    r = _drive_cluster(ctx, lambda: sched.scheduler, q, "remote", dev, busy_ok, local_rec,
                       local_tbl, flight_servers=[e.flight_server for e in execs
                                                  if e.flight_server is not None],
                       rpc=rpc, force_remote=force_remote, warm_runs=warm_runs, kernel=kernel,
                       rtol=rtol)
    return {**r, "config": extra_cfg, "executors": [
        {"policy": e.policy, "slots": e.metadata.vcores,
         "device_ordinal": e.metadata.device_ordinal,
         "flight": "python" if e.flight_server is not None else "native"} for e in execs]}


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rest(port: int, path: str):
    import urllib.request

    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=10) as r:
        return json.load(r)


def _compute_apps() -> list[list]:
    """The CUDA contexts nvidia-smi lists, as [pid, used memory] rows. In a
    container whose pid namespace nvidia-smi cannot see into, every row
    reads pid 1."""
    out = subprocess.run(["nvidia-smi", "--query-compute-apps=pid,used_memory",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=30, check=True).stdout
    log(f"nvidia-smi compute apps: {out.strip()!r}")
    return [[int(line.split(",")[0]), line.split(",")[1].strip()]
            for line in out.splitlines() if line.strip()]


def _children(pid: int) -> list[int]:
    """The pids whose parent is `pid` (from /proc)."""
    out = []
    for entry in filter(str.isdigit, os.listdir("/proc")):
        try:
            with open(f"/proc/{entry}/stat") as f:
                stat = f.read()
        except OSError:
            continue
        if int(stat.rsplit(")", 1)[1].split()[1]) == pid:
            out.append(int(entry))
    return out


def _running(pid: int) -> bool:
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except OSError:
        return False


def remote_daemons_check(big_dir: str, q4_dir: str, answers: dict) -> dict:
    """Phase 9 (c), the deployment shape: `python -m
    ballista_tpu_torch.scheduler` and `python -m ballista_tpu_torch.executor
    --engine tpu --device-ordinal 0` as subprocesses. The executor registers
    with ordinal 0 and one slot; q6 and q4 through SessionContext.remote
    answer as in phase 4, every device stage on the card in every task with
    no fallback (the job's metrics over GetJobMetrics); the daemon loads the
    kernels phase 2 built (no new library in the build directory); nvidia-smi
    lists the executor daemon as holding a CUDA context and not the
    scheduler daemon: while both run after the queries, nvidia-smi lists one
    context more than this process held alone, and after the executor's
    exit none more, with the scheduler still up (by pid too where nvidia-smi
    sees this pid namespace); SIGTERM drains the executor and it exits 0. On
    a failure the daemons' stderr tails are printed."""
    import shutil
    import signal

    from ballista_tpu_torch.client.context import SessionContext
    from ballista_tpu_torch.config import BallistaConfig
    from ballista_tpu_torch.ops.cuda import runtime
    from ballista_tpu_torch.testing.standalone_stats import job_metrics_stats
    from ballista_tpu_torch.testing.tpchgen import register_tpch

    os.makedirs(REMOTE_DIR, exist_ok=True)
    work = os.path.join(REMOTE_DIR, "daemon_executor")
    shutil.rmtree(work, ignore_errors=True)
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    env.pop("BALLISTA_TORCH_PLATFORM", None)  # the card, never the CPU
    port, rest, proxy = _free_port(), _free_port(), _free_port()
    addr = f"127.0.0.1:{port}"
    logs = {n: os.path.join(REMOTE_DIR, f"{n}.stderr") for n in ("scheduler", "executor")}
    cmds = {
        "scheduler": [sys.executable, "-m", "ballista_tpu_torch.scheduler",
                      "--bind-host", "127.0.0.1", "--port", str(port), "--rest-port", str(rest),
                      "--flight-proxy-port", str(proxy), "--log-level", "WARNING"],
        "executor": [sys.executable, "-m", "ballista_tpu_torch.executor", "--scheduler", addr,
                     "--bind-host", "127.0.0.1", "--external-host", "127.0.0.1",
                     "--engine", "tpu", "--device-ordinal", "0", "--work-dir", work,
                     "--log-level", "WARNING"],
    }
    built = sorted(os.listdir(runtime.compile_cache_dir()))
    alone = _compute_apps()  # this process's own context
    pids_seen = os.getpid() in [pid for pid, _ in alone]
    procs: dict = {}
    ok = False
    try:
        t0 = time.time()
        for name in ("scheduler", "executor"):
            procs[name] = subprocess.Popen(cmds[name], env=env, cwd=ROOT,
                                           stdout=subprocess.DEVNULL,
                                           stderr=open(logs[name], "wb"))
        info = []
        deadline = time.time() + DAEMON_DEADLINE_S
        while not info:
            for name, p in procs.items():
                if p.poll() is not None:
                    raise AssertionError(f"the {name} daemon exited {p.returncode}")
            if time.time() > deadline:
                raise AssertionError("the executor daemon did not register in time")
            try:
                info = _rest(rest, "/api/executors")
            except OSError:
                pass
            time.sleep(0.5)
        registered_s = time.time() - t0
        if [(e["device_ordinal"], e["total_slots"]) for e in info] != [(0, 1)]:
            raise AssertionError(f"the executor daemon registered as {info}")
        queries = {}
        for q, data_dir in ((6, big_dir), (4, q4_dir)):
            ctx = SessionContext.remote(addr, BallistaConfig(QUERY_CONFIG))
            register_tpch(ctx, data_dir)
            with open(os.path.join(ROOT, "benchmarks", "tpch", "queries", f"q{q}.sql")) as f:
                sql = f.read()
            walls = []
            for _ in range(2):  # cold, then warm
                t1 = time.time()
                tbl = ctx.sql(sql).collect()
                walls.append(time.time() - t1)
                compare_answers(tbl, answers[q][0], q)
                job = _rest(rest, "/api/jobs")[-1]
                stats = job_metrics_stats(ctx._ensure_remote().job_metrics(job["job_id"]))
                if not any(st["device"] for st in stats.values()):
                    raise AssertionError(f"q{q} daemons: no device stage ran")
                for sid, st in stats.items():
                    for kind, (nodes, passes, fallbacks) in st["device"].items():
                        if fallbacks or not passes == nodes == st["tasks"]:
                            raise AssertionError(
                                f"q{q} daemons: stage {sid}: {nodes} {kind}, {passes} device "
                                f"passes and {fallbacks} fallbacks in {st['tasks']} tasks")
            queries[f"q{q}"] = {"cold_wall_s": walls[0], "warm_wall_s": walls[1],
                                "device_nodes_per_stage": {
                                    sid: st["device"] for sid, st in stats.items()
                                    if st["device"]}}
        rebuilt = sorted(set(os.listdir(runtime.compile_cache_dir())) - set(built))
        if rebuilt:
            raise AssertionError(f"the executor daemon built kernels again: {rebuilt}")
        apps = _compute_apps()
        if len(apps) != len(alone) + 1:
            raise AssertionError(f"{len(apps)} CUDA contexts with both daemons up, this "
                                 f"process alone held {len(alone)}: {apps}")
        if pids_seen and (procs["executor"].pid not in [pid for pid, _ in apps]
                          or procs["scheduler"].pid in [pid for pid, _ in apps]):
            raise AssertionError(f"CUDA contexts {apps}: the executor daemon is pid "
                                 f"{procs['executor'].pid}, the scheduler {procs['scheduler'].pid}")
        kids = _children(procs["executor"].pid)  # its native Flight server, if it runs one
        t1 = time.time()
        procs["executor"].send_signal(signal.SIGTERM)
        rc = procs["executor"].wait(timeout=DAEMON_DEADLINE_S)
        drain_s = time.time() - t1
        if rc != 0:
            raise AssertionError(f"the executor daemon exited {rc} after SIGTERM")
        if [k for k in kids if _running(k)]:
            raise AssertionError(f"the executor daemon left its children {kids} running")
        deadline = time.time() + 30
        while len(after := _compute_apps()) != len(alone) and time.time() < deadline:
            time.sleep(1)
        if len(after) != len(alone) or procs["scheduler"].poll() is not None:
            raise AssertionError(f"after the executor's exit, with the scheduler daemon "
                                 f"{'up' if procs['scheduler'].poll() is None else 'gone'}, "
                                 f"nvidia-smi lists {after}; this process alone held {alone}")
        procs["scheduler"].send_signal(signal.SIGTERM)
        sched_rc = procs["scheduler"].wait(timeout=DAEMON_DEADLINE_S)
        ok = True
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
            p.wait()
        if not ok:
            for name, path in logs.items():
                with open(path, "rb") as f:
                    log(f"{name} daemon stderr tail:\n" + f.read()[-3000:].decode(errors="replace"))
        shutil.rmtree(work, ignore_errors=True)
    return {"query": "remote_daemons", "registered_s": registered_s, "executors": info,
            "queries": queries, "compute_apps": {"this_process": alone, "daemons_up": apps,
                                                 "executor_gone": after},
            "pids": {n: p.pid for n, p in procs.items()}, "pids_seen_by_nvidia_smi": pids_seen,
            "executor_children": kids,
            "sigterm_drain_s": drain_s,
            "executor_rc": rc, "scheduler_rc": sched_rc}


# ---------------------------------------------------------------- daemon

# phase 11: the warm device daemon on the --q4-scale data. The queries a
# fresh client process sends through it, their config, and the kernel the
# daemon must launch in each of their runs
DAEMON_QUERIES = ((4, {}, "masked_group_reduce"), (5, {}, "hash_probe"),
                  (12, {"ballista.tpu.fusion.mode": "fused_pallas"}, "dict_filter"),
                  (1, {}, None))
DAEMON_DIR = os.path.join(ROOT, "build", "daemon")  # client answers, specs, logs


def _daemon_socket() -> str:
    """The daemon's socket path: under build/daemon, or under the temporary
    directory where that path is past a unix socket's length limit."""
    import tempfile

    path = os.path.join(DAEMON_DIR, "d.sock")
    if len(path) < 100:
        return path
    return os.path.join(tempfile.mkdtemp(prefix="bdaemon"), "d.sock")


def _daemon_cfg(sock: str, extra: dict) -> dict:
    return {**QUERY_CONFIG, **extra, "ballista.tpu.daemon.enabled": True,
            "ballista.tpu.daemon.socket": sock,
            "ballista.tpu.daemon.attach.timeout.ms": 10_000}


def daemon_client_main(spec_path: str) -> int:
    """A fresh client process of phase 11 (`chip_smoke.py --daemon-client
    SPEC`). Its imports run while the daemon starts (or the client before
    it runs); then it waits for the daemon to be ready and, where the spec
    names a `go` file, for that file. Then every query of the spec cold and
    three times warm, and with `trace`
    once more under the daemon's profiler, each through the daemon; each
    run's wall, the daemon's launches in each run (its status before and
    after), every routed stage's daemon_mode, the warm answer as an Arrow
    IPC file; with `clear`, clear_device_caches() at the end with the
    daemon's status around it; then nvidia-smi's compute apps while this
    process still runs and whether it made a CUDA context. Makes no CUDA
    call of its own."""
    t_start = time.time()
    sys.path.insert(0, ROOT)
    import pyarrow as pa
    import torch

    from ballista_tpu_torch.client.context import SessionContext
    from ballista_tpu_torch.config import BallistaConfig
    from ballista_tpu_torch.device_daemon import client as dclient
    from ballista_tpu_torch.ops.cuda import stage_compiler as sc
    from ballista_tpu_torch.testing.tpchgen import register_tpch

    with open(spec_path) as f:
        spec = json.load(f)
    sock, out_dir = spec["socket"], spec["out_dir"]
    daemon = dclient.DaemonClient(sock)
    out = {"pid": os.getpid(), "import_s": time.time() - t_start, "queries": {}}
    t_wait = time.time()
    daemon.wait_ready(DAEMON_DEADLINE_S, poll_s=0.05)
    while spec["go"] and not os.path.exists(spec["go"]):
        if time.time() - t_wait > DAEMON_DEADLINE_S:
            raise TimeoutError(f"no {spec['go']} within {DAEMON_DEADLINE_S}s")
        time.sleep(0.02)
    out["wait_s"] = time.time() - t_wait
    t_queries = time.time()
    for q, extra, _kernel in spec["queries"]:
        ctx = SessionContext(BallistaConfig(_daemon_cfg(sock, extra)))
        register_tpch(ctx, spec["data_dir"])
        sql = _query_sql(q)
        rec = out["queries"][str(q)] = {"walls": [], "launches": [], "modes": []}
        runs = ["cold", "warm", "warm", "warm"] + (["traced"] if spec["trace"] else [])
        for run in runs:
            if run == "traced":
                daemon.profile(True)
            before = daemon.status()
            sc.RUN_STATS.clear()
            t0 = time.time()
            tbl = ctx.sql(sql).collect()
            rec["walls"].append(time.time() - t0)
            after = daemon.status()
            if run == "traced":
                daemon.profile(False)
                rec["device_busy_ms"] = after["device_busy_ms"] - before["device_busy_ms"]
                rec["traced_wall_s"] = rec["walls"].pop()
            else:
                rec["launches"].append({k: after["launches"][k] - before["launches"][k]
                                        for k in after["launches"]})
            rec["modes"].append(sorted({(t, r.get("daemon_mode"), r.get("daemon_mode_reason"))
                                        for t, r in sc.RUN_STATS.stages().items()
                                        if "daemon_mode" in r}))
            rec["fills"] = rec.get("fills", 0) + after["table_fills"] - before["table_fills"]
            if run == "warm" and len(rec["walls"]) == 4:  # the last warm run's answer
                with pa.OSFile(os.path.join(out_dir, f"q{q}.arrow"), "wb") as f:
                    with pa.ipc.new_stream(f, tbl.schema) as w:
                        w.write_table(tbl)
    if spec["clear"]:
        out["clear_before"] = daemon.status()
        sc.clear_device_caches()
        out["clear_after"] = daemon.status()
    out["compute_apps"] = _compute_apps()
    out["cuda_initialized"] = torch.cuda.is_initialized()
    out["queries_s"] = time.time() - t_queries
    out["wall_s"] = time.time() - t_start
    with open(os.path.join(out_dir, "result.json"), "w") as f:
        json.dump(out, f, default=list)
    return 0


def _start_daemon_client(name: str, sock: str, data_dir: str, trace: bool, clear: bool,
                         go: str = ""):
    """Start one fresh client process (daemon_client_main)."""
    out_dir = os.path.join(DAEMON_DIR, name)
    os.makedirs(out_dir, exist_ok=True)
    spec = os.path.join(out_dir, "spec.json")
    with open(spec, "w") as f:
        json.dump({"socket": sock, "out_dir": out_dir, "data_dir": data_dir,
                   "queries": DAEMON_QUERIES, "trace": trace, "clear": clear, "go": go}, f)
    env = {k: v for k, v in os.environ.items() if k != "BALLISTA_TORCH_PLATFORM"}
    err = open(os.path.join(out_dir, "stderr"), "wb")
    proc = subprocess.Popen([sys.executable, os.path.join(ROOT, "chip_smoke.py"),
                             "--daemon-client", spec], env=env, cwd=ROOT,
                            stdout=subprocess.DEVNULL, stderr=err)
    err.close()
    return name, out_dir, proc, time.time()


def _finish_daemon_client(started) -> dict:
    """Wait for a client process; its result, with the wall of the whole
    process as this process sees it and its answers' IPC bytes."""
    name, out_dir, proc, t0 = started
    rc = proc.wait(timeout=DAEMON_DEADLINE_S)
    wall = time.time() - t0
    if rc != 0:
        with open(os.path.join(out_dir, "stderr"), "rb") as f:
            tail = f.read()[-3000:].decode(errors="replace")
        raise AssertionError(f"daemon client {name} exited {rc}:\n{tail}")
    with open(os.path.join(out_dir, "result.json")) as f:
        r = json.load(f)
    r["process_wall_s"] = wall
    r["answers"] = {}
    for q, _e, _k in DAEMON_QUERIES:
        with open(os.path.join(out_dir, f"q{q}.arrow"), "rb") as f:
            r["answers"][q] = f.read()
    return r


def _hold_daemon_client(name: str, r: dict, local: dict, daemon_pid: int, alone: list) -> None:
    """Phase 11 (b)'s checks on one client: each answer as the local one at
    its scale, every routed stage attached, the kernel of each query
    launched by the daemon in each of its runs, no CUDA context in the
    client, and nvidia-smi listing the daemon's context beside this
    process's and not the client's."""
    import pyarrow as pa

    for q, _e, kernel in DAEMON_QUERIES:
        rec = r["queries"][str(q)]
        compare_answers(pa.ipc.open_stream(r["answers"][q]).read_all(), local[q], q)
        for modes in rec["modes"]:
            if not modes or any(m != "attached" for _t, m, _r in modes):
                raise AssertionError(f"{name} q{q}: routed stages {modes}, all attached expected")
        if kernel is not None and min(run[kernel] for run in rec["launches"]) < 1:
            raise AssertionError(f"{name} q{q}: the daemon launched {kernel} "
                                 f"{[run[kernel] for run in rec['launches']]} times a run")
    if r["cuda_initialized"]:
        raise AssertionError(f"{name}: the client process initialised CUDA")
    apps = r["compute_apps"]
    pids = [pid for pid, _ in apps]
    if len(apps) != len(alone) + 1 or r["pid"] in pids or (
            os.getpid() in [pid for pid, _ in alone] and daemon_pid not in pids):
        raise AssertionError(f"{name}: nvidia-smi listed {apps} while the client ran "
                             f"(pid {r['pid']}); this process alone {alone}, the daemon pid "
                             f"{daemon_pid}")


def daemon_phase(q4_dir: str, local: dict) -> dict:
    """Phase 11, the warm device daemon on the card: (a) spawn it on
    ordinal 0 and read its probe report (init phases, budget, no kernel
    built); (b) a fresh client process runs DAEMON_QUERIES through it
    (_hold_daemon_client); the clients' imports run while the daemon
    starts, and the second client's while the first runs (it waits for a
    `go` file); (c) a second fresh client gets byte-identical
    answers with the daemon's tables hit and none filled, no kernel
    library built, and (e) ends with clear_device_caches(), which empties
    the daemon's resident tables; (d) in this process, daemon_crash armed
    at mid_execute once: q4 answers byte-identically after one respawn,
    daemon_restarts 1, a new generation; (f) SIGTERM: the respawned daemon
    exits 0 and its socket is gone. `local`: the local answers at
    --q4-scale. On a failure the daemons' log tail is printed."""
    import shutil
    import signal

    import pyarrow as pa

    from ballista_tpu_torch.config import (
        CHAOS_DAEMON_ARM,
        CHAOS_DAEMON_ONCE,
        CHAOS_ENABLED,
        CHAOS_MODE,
        TPU_DAEMON_ATTACH_TIMEOUT_MS,
        TPU_DAEMON_SPAWN,
        BallistaConfig,
    )
    from ballista_tpu_torch.client.context import SessionContext
    from ballista_tpu_torch.device_daemon import client as dclient
    from ballista_tpu_torch.device_daemon import protocol as dproto
    from ballista_tpu_torch.ops.cuda import runtime
    from ballista_tpu_torch.ops.cuda import stage_compiler as sc
    from ballista_tpu_torch.testing.tpchgen import register_tpch

    shutil.rmtree(DAEMON_DIR, ignore_errors=True)
    os.makedirs(DAEMON_DIR)
    sock = _daemon_socket()
    built = sorted(os.listdir(runtime.compile_cache_dir()))
    alone = _compute_apps()  # this process's own context
    env = {k: v for k, v in os.environ.items() if k != "BALLISTA_TORCH_PLATFORM"}
    go = os.path.join(DAEMON_DIR, "client2.go")
    procs, clients, ok = [], [], False
    try:
        t0 = time.time()
        procs.append(dclient.spawn_daemon(sock, parent_pid=os.getpid(), device_ordinal=0,
                                          env=env))
        clients.append(_start_daemon_client("client1", sock, q4_dir, trace=False, clear=False))
        clients.append(_start_daemon_client("client2", sock, q4_dir, trace=True, clear=True,
                                            go=go))
        daemon = dclient.DaemonClient(sock)
        ready = daemon.wait_ready(DAEMON_DEADLINE_S, poll_s=0.05)
        ready_s = time.time() - t0
        with open(dproto.probe_report_path(sock)) as f:
            report = json.load(f)
        if report.get("kernels_built"):
            raise AssertionError(f"the daemon built {report['kernels_built']}: phase 2 built them")
        log(f"daemon pid {ready['pid']} ready in {ready_s:.2f}s on {report['device_kind']}: "
            f"init {[(p['name'], p['s']) for p in report['phases']]}, budget "
            f"{report['budget_bytes']} B, kernel loads {report['kernel_loads']}")
        c1 = _finish_daemon_client(clients[0])
        _hold_daemon_client("client1", c1, local, ready["pid"], alone)
        st1 = daemon.status()
        with open(go, "w"):
            pass
        c2 = _finish_daemon_client(clients[1])
        _hold_daemon_client("client2", c2, local, ready["pid"], alone)
        st2 = c2["clear_before"]
        for q, _e, _k in DAEMON_QUERIES:
            if c2["answers"][q] != c1["answers"][q]:
                raise AssertionError(f"q{q}: the second client's answer differs from the first's")
            if c2["queries"][str(q)]["fills"]:
                raise AssertionError(f"q{q}: the second client's runs filled a table")
        if st2["table_fills"] != st1["table_fills"] or st2["table_hits"] <= st1["table_hits"]:
            raise AssertionError(f"the daemon's tables: fills {st1['table_fills']} -> "
                                 f"{st2['table_fills']}, hits {st1['table_hits']} -> "
                                 f"{st2['table_hits']}")
        if st2["persist_cache"]["misses"] or sorted(os.listdir(runtime.compile_cache_dir())) != built:
            raise AssertionError(f"a kernel library was built: {st2['persist_cache']}")
        cleared = c2["clear_after"]
        if not st2["resident_tables"] or cleared["resident_tables"] or \
                cleared["clear_count"] != st2["clear_count"] + 1:
            raise AssertionError(f"clear_device_caches from a client: resident tables "
                                 f"{st2['resident_tables']} -> {cleared['resident_tables']}")
        # (d) the failure domain, this process as the client
        dclient.reset_attach_cache()
        dclient.reset_failure_counters()
        gen1 = daemon.ping()["gen"]
        cfg = _daemon_cfg(sock, {TPU_DAEMON_SPAWN: True, TPU_DAEMON_ATTACH_TIMEOUT_MS: 120_000,
                                 CHAOS_ENABLED: True, CHAOS_MODE: "daemon_crash",
                                 CHAOS_DAEMON_ARM: "mid_execute", CHAOS_DAEMON_ONCE: True})
        ctx = SessionContext(BallistaConfig(cfg))
        register_tpch(ctx, q4_dir)
        sc.RUN_STATS.clear()
        t1 = time.time()
        tbl = ctx.sql(_query_sql(4)).collect()
        crash_wall = time.time() - t1
        sink = pa.BufferOutputStream()
        with pa.ipc.new_stream(sink, tbl.schema) as w:
            w.write_table(tbl)
        counters = dclient.failure_counters()
        crashed_rc = procs[0].wait(timeout=30)
        procs.append(dclient.spawned_daemon(sock))
        gen2 = dclient.attached_generation(sock)
        failovers = {r.get("daemon_failover") for r in sc.RUN_STATS.stages().values()}
        if (sink.getvalue().to_pybytes() != c1["answers"][4] or counters["daemon_restarts"] != 1
                or counters["daemon_crashes_detected"] != 1 or counters["poisoned_stages"]
                or crashed_rc != 137 or not gen2 or gen2 == gen1
                or "daemon_restarted" not in failovers or procs[1] is None):
            raise AssertionError(f"daemon_crash at mid_execute: counters {counters}, exit "
                                 f"{crashed_rc}, generations {gen1} -> {gen2}, failovers "
                                 f"{failovers}, answer equal "
                                 f"{sink.getvalue().to_pybytes() == c1['answers'][4]}")
        respawned = dclient.DaemonClient(sock).status()
        # (f) SIGTERM ends the respawned daemon cleanly
        t1 = time.time()
        procs[1].send_signal(signal.SIGTERM)
        term_rc = procs[1].wait(timeout=30)
        term_s = time.time() - t1
        if term_rc != 0 or os.path.exists(sock):
            raise AssertionError(f"after SIGTERM the daemon exited {term_rc}, socket left: "
                                 f"{os.path.exists(sock)}")
        ok = True
    finally:
        for p in procs + [c[2] for c in clients]:
            if p is not None and p.poll() is None:
                p.kill()
                p.wait()
        dclient.reset_attach_cache()
        if not ok:
            with contextlib.suppress(OSError), open(dproto.daemon_log_path(sock), "rb") as f:
                log("device daemon log tail:\n" + f.read()[-4000:].decode(errors="replace"))

    def walls(c) -> dict:
        return {f"q{q}": {"cold_s": c["queries"][str(q)]["walls"][0],
                          "warm_s": min(c["queries"][str(q)]["walls"][1:]),
                          "warm_times_s": c["queries"][str(q)]["walls"][1:]}
                for q, _e, _k in DAEMON_QUERIES}

    launches = {f"q{q}": {k: sum(run[k] for c in (c1, c2) for run in c["queries"][str(q)]["launches"])
                          for k in c1["queries"][str(q)]["launches"][0]}
                for q, _e, _k in DAEMON_QUERIES}
    return {
        "query": "device_daemon", "socket": sock, "daemon_pid": ready["pid"],
        "ready_s": ready_s, "init_phase_s": {p["name"]: p["s"] for p in report["phases"]},
        "budget_bytes": report["budget_bytes"], "kernel_loads": report["kernel_loads"],
        "device_memory_bytes": report.get("device_memory_bytes"),
        "clients": {name: {"process_wall_s": c["process_wall_s"], "import_s": c["import_s"],
                           "wait_s": c["wait_s"], "queries_s": c["queries_s"],
                           "wall_s": c["wall_s"], "walls": walls(c),
                           "compute_apps": c["compute_apps"]}
                    for name, c in (("client1", c1), ("client2", c2))},
        "second_over_first": {f"q{q}": {run: walls(c2)[f"q{q}"][run] / walls(c1)[f"q{q}"][run]
                                        for run in ("cold_s", "warm_s")}
                              for q, _e, _k in DAEMON_QUERIES},
        "device_busy_ms": {f"q{q}": c2["queries"][str(q)]["device_busy_ms"]
                           for q, _e, _k in DAEMON_QUERIES},
        "traced_wall_s": {f"q{q}": c2["queries"][str(q)]["traced_wall_s"]
                          for q, _e, _k in DAEMON_QUERIES},
        "launches": launches,
        "tables": {"after_client1": {k: st1[k] for k in ("table_fills", "table_hits",
                                                        "resident_tables", "resident_bytes")},
                   "after_client2": {k: st2[k] for k in ("table_fills", "table_hits",
                                                        "resident_tables", "resident_bytes")},
                   "after_clear": {k: cleared[k] for k in ("resident_tables", "resident_bytes")}},
        "crash": {"wall_s": crash_wall, "counters": counters, "exit_code": crashed_rc,
                  "generations": [gen1, gen2], "respawned_pid": respawned["pid"],
                  "respawned_init_phase_s": {p["name"]: p["s"]
                                             for p in respawned["init"]["phases"]}},
        "sigterm": {"exit_code": term_rc, "seconds": term_s},
        "alone_compute_apps": alone,
    }


# ---------------------------------------------------------------- tpcds

DEVICE_NODE_KINDS = ("TpuStageExec", "TpuFinalStageExec", "TpuSortStageExec",
                     "TpuWindowStageExec")
SORT_NODE_KINDS = ("TpuSortStageExec", "TpuWindowStageExec")
TPCDS_SMALL_SCALE = 0.1  # phase 10 (a): every query, at the tests' scale
TPCDS_BIG_SCALE = 10.0  # phase 10 (b): 3,000,000 store_sales rows
# phase 10 (b): the sort and window shapes the JAX package's tests pin
# (tests/test_tpcds.py:87), then q93, a lookup after an expansion join (C12)
TPCDS_BIG_QUERIES = (36, 47, 67, 86, 98, 93)
# q64's final stages read two columns of each name below and decline (C14);
# its partial stages decline too, on the CPU form and in the JAX package
# alike ("code comparison must be pre-lowered via LUT")
TPCDS_C14 = (64, "duplicate input field names "
                 "['ca_street_name', 'ca_street_number', 'ca_zip', 'd_year']")
SIX_KERNELS = ("segmented_sort", "topk_select", "segmented_scan", "hash_probe",
               "dict_filter", "masked_group_reduce")
# masked_group_reduce sums in float32, as the JAX package's Pallas kernel
# does, whose own tests bound it so (tests/test_fusion.py:159-161): where a
# run launched it, the float columns hold to this (TPC-DS q18's averages
# differ from the CPU engine's by up to 7.6e-8, and equal the JAX
# package's fused_pallas answer byte for byte on the CPU)
F32_LANE_RTOL = 1e-4


def _pow2(n: int) -> int:
    return 1 << max(int(n) - 1, 0).bit_length()


def _tpcds_session(data_dir: str):
    from ballista_tpu_torch.client.context import SessionContext
    from ballista_tpu_torch.config import BallistaConfig
    from ballista_tpu_torch.testing.tpcdsgen import register_tpcds

    ctx = SessionContext(BallistaConfig(dict(QUERY_CONFIG)))
    register_tpcds(ctx, data_dir)
    return ctx


def _tpcds_card_run(ctx, sql: str):
    """(answer or None, [error type, message] or None, executed plan, wall,
    plan seconds) of one run on the card. An error is not the phase's
    failure yet: _hold_tpcds_run holds it against the CPU form's."""
    from ballista_tpu_torch.engine.cuda_engine import maybe_compile_tpu

    t0 = time.time()
    physical = maybe_compile_tpu(ctx.create_physical_plan(ctx.sql(sql).plan), ctx.config)
    plan_s = time.time() - t0
    try:
        tbl, error = ctx.execute_collect(physical), None
    except Exception as e:  # noqa: BLE001 — held against the CPU form's outcome
        tbl, error = None, [type(e).__name__, str(e)]
    return tbl, error, physical, time.time() - t0, plan_s


def _hold_tpcds_run(q: int, tbl, error, physical, cpu_tbl, cpu_form: dict,
                    launches: dict) -> list:
    """Hold one card run of TPC-DS q to the port's CPU form and engine=cpu:
    every query answers as engine=cpu (ints, dates, strings exact, floats within rtol
    1e-9, F32_LANE_RTOL where the run launched masked_group_reduce, in row
    order) with the CPU form's device claims, each node claimed, run and
    fallen back alike (_claimed); q64's final stages fall back for C14's
    reason. Returns the claims."""
    if error is not None or cpu_form["error"] is not None:
        raise AssertionError(f"TPC-DS q{q}: the card raised {error}, the CPU form "
                             f"{cpu_form['error']}")
    compare_answers(tbl, cpu_tbl, q,
                    F32_LANE_RTOL if launches.get("masked_group_reduce") else 1e-9)
    claims = device_claims(physical)
    if _claimed(claims) != _claimed(cpu_form["claims"]):
        raise AssertionError(f"TPC-DS q{q}: device claims {claims} on the card, "
                             f"{cpu_form['claims']} on the CPU form")
    finals = [n for n in _walk(physical) if type(n).__name__ == "TpuFinalStageExec"]
    if q == TPCDS_C14[0] and not (
            finals and all(n.fallback_count and n.decline_reason == TPCDS_C14[1]
                           for n in finals)):
        raise AssertionError(f"TPC-DS q64: final stages {claims}, reasons "
                             f"{_decline_reasons(physical)}; C14's expected")
    return claims


def _claimed(claims: list) -> list:
    """Per device node in plan order: its kind, whether it ran on the
    device and whether it fell back. How often a node runs is left out: a
    consumer that re-reads a partition re-runs its stage, as threads meet."""
    return [[kind, runs > 0, fallbacks > 0] for kind, runs, fallbacks in claims]


def _node_summary(claims: list) -> dict:
    """{kind: [nodes, device runs, fallbacks]}."""
    out: dict = {}
    for kind, runs, fallbacks in claims:
        d = out.setdefault(kind, [0, 0, 0])
        d[0] += 1
        d[1] += runs
        d[2] += fallbacks
    return out


def tpcds_small_phase(data_dir: str, card: str) -> dict:
    """Phase 10 (a): all 99 queries once on the card, each held by
    _hold_tpcds_run; one JSON line each. The launch counts are set to 0
    just before each query and read just after; returns their sums."""
    from ballista_tpu_torch.ops.cuda import cuda_kernels as ck

    totals: dict = {}
    t0 = time.time()
    for q in range(1, 100):
        cpu_tbl, cpu_s, cpu_form = ORACLE.tpcds(q, data_dir)
        ctx = _tpcds_session(data_dir)
        ck.reset_launches()
        tbl, error, physical, wall, plan_s = _tpcds_card_run(ctx, _tpcds_sql(q))
        launches = {k: v for k, v in ck.LAUNCHES.items() if v}
        claims = _hold_tpcds_run(q, tbl, error, physical, cpu_tbl, cpu_form, launches)
        for k, v in launches.items():
            totals[k] = totals.get(k, 0) + v
        print(json.dumps({
            "query": f"tpcds_q{q}", "scale": TPCDS_SMALL_SCALE, "card": card,
            "outcome": "answer" if error is None else error[0],
            "rows_out": None if tbl is None else tbl.num_rows, "wall_s": wall,
            "plan_s": plan_s, "cpu_engine_s": cpu_s,
            "device_nodes": _node_summary(claims), "declines": _decline_reasons(physical),
            "kernel_launches": launches}), flush=True)
    log(f"TPC-DS at scale {TPCDS_SMALL_SCALE:g}: 99 queries on the card in "
        f"{time.time() - t0:.1f}s, each as the CPU form and engine=cpu; launches {totals}")
    return totals


def _sort_decisions(physical) -> list:
    """Per sort or window node: its runs, the cost model's modes and
    reasons, the rows it sorted and the padded lanes of its kernels."""
    out = []
    for n in _walk(physical):
        if type(n).__name__ not in SORT_NODE_KINDS:
            continue
        modes: dict = {}
        for mode, _reason, _rows in n.decisions:
            modes[mode] = modes.get(mode, 0) + 1
        out.append({
            "kind": type(n).__name__, "device_runs": n.tpu_count,
            "fallbacks": n.fallback_count, "fusion_modes": modes,
            "fusion_reasons": sorted({r for _m, r, _n in n.decisions}),
            "rows": sorted(rows for _m, _r, rows in n.decisions),
            "padded_lanes": sorted({_pow2(rows) for m, _r, rows in n.decisions
                                    if m == "fused_pallas"})})
    return out


def _check_sort_launches(label: str, stages: list, launches: dict) -> None:
    """A sort stage the cost model sent to fused_pallas launches
    segmented_sort or topk_select in its run, a window stage
    segmented_scan."""
    pallas = {s["kind"] for s in stages if s["fusion_modes"].get("fused_pallas")}
    if "TpuSortStageExec" in pallas and not (launches["segmented_sort"]
                                             + launches["topk_select"]):
        raise AssertionError(f"{label}: a fused_pallas sort stage launched no kernel")
    if "TpuWindowStageExec" in pallas and not launches["segmented_scan"]:
        raise AssertionError(f"{label}: a fused_pallas window stage launched no scan")


def run_tpcds_big_query(q: int, data_dir: str, dev, busy_ok: bool, warm: int = 3) -> dict:
    """Phase 10 (b), one query: a cold run (the warm-up, as in phase 4),
    best of `warm` and one traced run, each held by _hold_tpcds_run and its
    sort and window stages
    by _check_sort_launches; the launches per run, the sort and window
    stages' decisions, busy time, idle share, the six largest device ops
    and the peak device bytes."""
    import torch

    from ballista_tpu_torch.ops.cuda import cuda_kernels as ck

    cpu_tbl, cpu_s, cpu_form = ORACLE.tpcds(q, data_dir)
    sql = _tpcds_sql(q)
    ctx = _tpcds_session(data_dir)
    torch.cuda.reset_peak_memory_stats(dev)
    walls, plan_times, run_launches, stages = [], [], [], []

    def one_run():
        before = dict(ck.LAUNCHES)
        tbl, error, physical, wall, plan_s = _tpcds_card_run(ctx, sql)
        run_launches.append({k: ck.LAUNCHES[k] - before[k] for k in SIX_KERNELS})
        claims = _hold_tpcds_run(q, tbl, error, physical, cpu_tbl, cpu_form,
                                 run_launches[-1])
        stages.append(_sort_decisions(physical))
        _check_sort_launches(f"TPC-DS q{q}", stages[-1], run_launches[-1])
        walls.append(wall)
        plan_times.append(plan_s)
        return claims

    for _ in range(1 + warm):  # cold, then best of `warm`
        claims = one_run()
    peak = torch.cuda.max_memory_allocated(dev)
    t0 = time.time()
    by_name: dict = {}
    busy = device_busy_ms(one_run, by_name=by_name) if busy_ok else None
    traced_wall = time.time() - t0
    top_ops = sorted(([n[:80], ms, c] for n, (ms, c) in by_name.items()),
                     key=lambda r: -r[1])[:6]
    best = min(range(1, 1 + warm), key=lambda k: walls[k])
    pallas = [s for s in stages[best] if s["fusion_modes"].get("fused_pallas")]
    not_pallas = [s["fusion_reasons"] for s in stages[best]
                  if not s["fusion_modes"].get("fused_pallas")]
    log(f"TPC-DS q{q} at scale {TPCDS_BIG_SCALE:g}: equal to engine=cpu in every run, "
        f"claims as the CPU form {_node_summary(claims)}; {len(pallas)} of "
        f"{len(stages[best])} sort/window stages fused_pallas (lanes "
        f"{sorted({x for s in pallas for x in s['padded_lanes']})}); the others: "
        f"{not_pallas}; launches per run {run_launches[best]}")
    return {
        "query": f"tpcds_q{q}", "wall_s": walls[best], "times_s": walls[1:1 + warm],
        "cold_wall_s": walls[0], "plan_s": plan_times[best], "cpu_engine_s": cpu_s,
        "rows_out": cpu_tbl.num_rows, "device_nodes": _node_summary(claims),
        "sort_window_stages": stages[best], "kernel_launches_per_run": run_launches,
        "traced_wall_s": traced_wall, "device_busy_ms": busy, "top_device_ops": top_ops,
        "device_idle_share": None if busy is None else 1.0 - busy / 1e3 / traced_wall,
        "peak_device_bytes": peak,
    }


# ---------------------------------------------------------------- serving

# phase 12: the serving surface (client/context.py prepare / execute /
# subscribe / append, client/direct.py) on the card. The deltas appended in
# (b) and (d): lineitem from the port's generator at this scale and these
# seeds (about 60,000 rows each, above ballista.tpu.min.rows's default 8192)
SERVING_DELTA_SCALE = 0.01
SERVING_DELTA_SEEDS = (43, 44, 45)
SERVING_SMALL_DELTA_ROWS = 20_000  # (d): the head of the first delta
GENERATORS.update({f"delta{seed}": ("ballista_tpu_torch.testing.tpchgen", "generate_tpch",
                                    seed, 1) for seed in SERVING_DELTA_SEEDS})
_YEAR_ON = (("date '1995-01-01'", "date '1996-01-01'"),
            ("date '1994-01-01'", "date '1995-01-01'"))
# q1's grouping and filter with its COUNT only: the generator stores
# quantities and prices as float64, so q1's SUMs are float sums, which
# analyze_plan declines ("float-sum") in both packages
Q1_COUNT_SQL = ("select l_returnflag, l_linestatus, count(*) as count_order "
                "from lineitem where l_shipdate <= date '1998-09-02' "
                "group by l_returnflag, l_linestatus order by l_returnflag, l_linestatus")
# (c): a single-stage statement (scan, filter, project); the device engine
# claims partial aggregates, and every aggregate plan has two stages
DIRECT_SQL = "select l_orderkey, l_partkey, l_quantity from lineitem where l_quantity < 2"
DIRECT_PARAMS = ((2,), (3,), (5,))
SERVING_CONFIG = {**QUERY_CONFIG, "ballista.scheduler.lease.enabled": True}


def serving_statements() -> list:
    """(a): (name, A text, B text, config, kernel), each at --q4-scale (q6
    and q12 cut from --scale for the run's time limit, PERF.md §4:
    standalone q12 at SF10 took about 6 s an execution, one broadcast
    build a job). q12's ship modes are `=` predicates here: an IN list's
    values are the plan's shape, not parameter slots, in both packages."""
    q12 = _query_sql(12).replace("l_shipmode in ('MAIL', 'SHIP')",
                                 "(l_shipmode = 'MAIL' or l_shipmode = 'SHIP')")
    out = []
    for name, a, reps, extra, kernel in (
            ("q6", _query_sql(6), _YEAR_ON + (("0.05 and 0.07", "0.04 and 0.06"),
                                              ("< 24", "< 30")), {}, None),
            ("q4", _query_sql(4), (("date '1993-10-01'", "date '1994-01-01'"),
                                   ("date '1993-07-01'", "date '1993-10-01'")),
             {}, "masked_group_reduce"),
            ("q5", _query_sql(5), (("'ASIA'", "'EUROPE'"),) + _YEAR_ON, {}, "hash_probe"),
            ("q12", q12, (("'MAIL'", "'AIR'"), ("'SHIP'", "'RAIL'")),
             {"ballista.tpu.fusion.mode": "fused_pallas"}, "dict_filter")):
        b = a
        for old, new in reps:
            if old not in b:
                raise AssertionError(f"{name}: no {old} in its text")
            b = b.replace(old, new)
        out.append((name, a, b, extra, kernel))
    return out


def _lineitem_delta(delta_dir: str, head: int = 0):
    import pyarrow.parquet as pq

    tbl = pq.read_table(os.path.join(delta_dir, "lineitem"))
    return tbl.slice(0, head) if head else tbl


def _serving_oracle_job(sql: str, data_dir: str, delta_dirs: tuple, head: int):
    """The port's engine=cpu answer to `sql` over `data_dir` with each of
    `delta_dirs`' lineitem appended (its first `head` rows where given), in
    local mode, as an Arrow IPC stream, and its wall."""
    import pyarrow as pa

    from ballista_tpu_torch.client.context import SessionContext
    from ballista_tpu_torch.config import BallistaConfig
    from ballista_tpu_torch.testing.tpchgen import register_tpch

    ctx = SessionContext(BallistaConfig({"ballista.executor.engine": "cpu"}))
    register_tpch(ctx, data_dir)
    for d in delta_dirs:
        ctx.append("lineitem", _lineitem_delta(d, head))
    t0 = time.time()
    tbl = ctx.sql(sql).collect()
    seconds = time.time() - t0
    sink = pa.BufferOutputStream()
    with pa.ipc.new_stream(sink, tbl.schema) as w:
        w.write_table(tbl)
    return sink.getvalue(), seconds


def submit_serving_oracle(q4_dir: str, delta_dirs: list) -> None:
    """Phase 12's engine=cpu answers, into the oracle's pools: (a)'s
    statements with A's and B's literals, (b)'s after 0-3 deltas, (c)'s
    parameter sets and (d)'s delta."""
    for name, a, b, _extra, _k in serving_statements():
        for tag, text in (("a", a), ("b", b)):
            ORACLE._submit(("serving", name, tag), _serving_oracle_job, text, q4_dir,
                                (), 0)
    for name, sql in (("q1_count", Q1_COUNT_SQL), ("q12_join", _query_sql(12))):
        for k in range(len(delta_dirs) + 1):
            ORACLE._submit(("serving", name, k), _serving_oracle_job, sql, q4_dir,
                                tuple(delta_dirs[:k]), 0)
    ORACLE._submit(("serving", "q1_count", "small_delta"), _serving_oracle_job,
                        Q1_COUNT_SQL, q4_dir, tuple(delta_dirs[:1]), SERVING_SMALL_DELTA_ROWS)
    for (k,) in DIRECT_PARAMS:
        ORACLE._submit(("serving", "direct", k), _serving_oracle_job,
                            DIRECT_SQL.replace("< 2", f"< {k}"), q4_dir, (), 0)


def _sorted_rows(tbl):
    return tbl.sort_by([(n, "ascending") for n in tbl.column_names])


def _job_device(jobs: list) -> dict:
    """{node kind: [nodes, device passes, fallbacks]} summed over `jobs`."""
    from ballista_tpu_torch.testing.standalone_stats import stage_stats

    out: dict = {}
    for job in jobs:
        for st in stage_stats(job).values():
            for kind, counts in st["device"].items():
                acc = out.setdefault(kind, [0, 0, 0])
                for i, v in enumerate(counts):
                    acc[i] += v
    return out


def _jobs_since(scheduler, seen: set) -> list:
    with scheduler._jobs_lock:
        return [j for jid, j in scheduler.jobs.items() if jid not in seen]


class _CompiledPlans:
    """The device plans a local-mode execution compiled: `execute_collect`
    imports maybe_compile_tpu from the engine on every call; this wrapper
    hands the result on unchanged and keeps it, so a prepared statement's
    device passes can be read from its nodes' counters."""

    def __init__(self):
        self.plans: list = []

    def __enter__(self):
        from ballista_tpu_torch.engine import cuda_engine

        self._orig = cuda_engine.maybe_compile_tpu

        def keep(plan, config):
            out = self._orig(plan, config)
            self.plans.append(out)
            return out

        cuda_engine.maybe_compile_tpu = keep
        return self

    def __exit__(self, *exc):
        from ballista_tpu_torch.engine import cuda_engine

        cuda_engine.maybe_compile_tpu = self._orig

    def device(self) -> dict:
        out: dict = {}
        for plan in self.plans:
            for kind, runs, fallbacks in device_claims(plan):
                acc = out.setdefault(kind, [0, 0, 0])
                acc[0] += 1
                acc[1] += runs
                acc[2] += fallbacks
        self.plans = []
        return out


def _hold_device(label: str, device: dict, passes_per_node: int = 1) -> None:
    """Every device node ran on the card, none fell back."""
    if not device:
        raise AssertionError(f"{label}: no device stage ran")
    for kind, (nodes, passes, fallbacks) in device.items():
        if fallbacks or passes < nodes * passes_per_node:
            raise AssertionError(f"{label}: {nodes} {kind} ran {passes} device passes "
                                 f"and {fallbacks} fallbacks")


def _prepared_cell(mode: str, ctx, stmt, scheduler, busy_ok: bool) -> dict:
    """(a), one statement in one mode: prepared once, executed A, B, A; each
    answer held to the engine=cpu answer of that text (floats rtol 1e-9, or
    F32_LANE_RTOL where masked_group_reduce ran), every device stage on the
    card with no fallback, the kernel launched in every execution; then one
    traced warm execution of A. `scheduler`: the cluster's, None locally."""
    from ballista_tpu_torch.ops.cuda import cuda_kernels as ck

    name, a_text, b_text, _extra, kernel = stmt
    params = {"a": _lift_values(ctx, a_text), "b": _lift_values(ctx, b_text)}
    t0 = time.time()
    ps = ctx.prepare(a_text)
    prepare_s = time.time() - t0
    if ps.num_params != len(params["a"]):
        raise AssertionError(f"{name} {mode}: {ps.num_params} slots, {len(params['a'])} lifted")
    execs = []
    compiled = _CompiledPlans()
    try:
        for tag in ("a", "b", "a"):
            snap = scheduler.serving.snapshot() if scheduler is not None else None
            seen = set(scheduler.jobs) if scheduler is not None else set()
            before = dict(ck.LAUNCHES)
            with compiled:
                t1 = time.time()
                tbl = ps.execute(params[tag])
                wall = time.time() - t1
            launches = {k: ck.LAUNCHES[k] - before[k] for k in before}
            compare_answers(tbl, ORACLE.keyed(("serving", name, tag))[0], f"{name} {mode} {tag}",
                            F32_LANE_RTOL if launches["masked_group_reduce"] else 1e-9)
            cached = plan_hit = None
            if scheduler is None:
                device = compiled.device()
            else:
                after = scheduler.serving.snapshot()
                device = _job_device(_jobs_since(scheduler, seen))
                cached = after["result_cache"]["hits"] > snap["result_cache"]["hits"]
                plan_hit = after["plan_cache"]["hits"] > snap["plan_cache"]["hits"]
            if not cached:
                _hold_device(f"{name} {mode} {tag}", device)
                if kernel is not None and launches[kernel] < 1:
                    raise AssertionError(f"{name} {mode} {tag}: no {kernel} launch")
            execs.append({"params": tag, "wall_s": wall, "plan_cache_hit": plan_hit,
                          "result_cache_hit": cached, "device_nodes": device,
                          "device_passes": sum(d[1] for d in device.values()),
                          "kernel_launches": {k: v for k, v in launches.items() if v},
                          "rows_out": tbl.num_rows})
        busy = traced_wall = None
        if busy_ok:
            t1 = time.time()
            busy = device_busy_ms(lambda: ps.execute(params["a"]))
            traced_wall = time.time() - t1
    finally:
        ps.close()
    log(f"{name} {mode}: A, B, A equal to engine=cpu; walls "
        f"{[round(e['wall_s'], 4) for e in execs]}; passes {[e['device_passes'] for e in execs]}")
    return {"query": f"serving_{mode}_{name}", "prepare_s": prepare_s, "executions": execs,
            "params": {k: [str(x) for x in v] for k, v in params.items()},
            "device_busy_ms": busy, "traced_wall_s": traced_wall,
            "device_idle_share": None if busy is None else 1.0 - busy / 1e3 / traced_wall}


def _lift_values(ctx, sql: str) -> list:
    """The slot values of `sql` as the port lifts them: the parameters a
    prepared statement of A's text takes to answer B's text."""
    from ballista_tpu_torch.serving.normalize import lift_parameters
    from ballista_tpu_torch.sql.optimizer import optimize
    from ballista_tpu_torch.sql.parser import parse_sql
    from ballista_tpu_torch.sql.planner import SqlPlanner

    lift = lift_parameters(optimize(SqlPlanner(ctx.catalog).plan_query(parse_sql(sql))))
    if not lift.cacheable:
        raise AssertionError(f"statement not parameterizable: {lift.reason}")
    return list(lift.values)


def _subscriptions_cell(q4_dir: str, delta_dirs: list, busy_ok: bool) -> dict:
    """(b): continuous queries over SF1 lineitem in the standalone mode, the
    result cache on: q1's grouping with its COUNT (maintained) and q12, a
    delta join (orders ⋈ lineitem, only lineitem appended). Each delta is
    appended once, and both subscriptions push a refresh; every push equals
    engine=cpu over the base and every delta so far. Per refresh: the
    statement's incremental_mode and reason, the maintained count, the
    jobs' device nodes (the delta stage on the card or not), the time from
    append returning to the push, and the kernel launches. The third
    append is traced."""
    import queue

    from ballista_tpu_torch.client.context import SessionContext
    from ballista_tpu_torch.config import BallistaConfig
    from ballista_tpu_torch.ops.cuda import cuda_kernels as ck
    from ballista_tpu_torch.testing.tpchgen import register_tpch

    cfg = {**SERVING_CONFIG, "ballista.serving.result.cache.enabled": True}
    ctx = SessionContext.standalone(BallistaConfig(cfg), num_executors=1, vcores=4)
    subs = {}
    try:
        register_tpch(ctx, q4_dir)
        scheduler = ctx._ensure_cluster().scheduler
        for name, sql in (("q1_count", Q1_COUNT_SQL), ("q12_join", _query_sql(12))):
            ps = ctx.prepare(sql)
            sub = ps.subscribe()
            t0 = time.time()
            first = sub.next(timeout=300)
            compare_answers(first, ORACLE.keyed(("serving", name, 0))[0], f"{name} base")
            key = scheduler.serving.get_prepared(ps.statement_id).key
            subs[name] = (ps, sub, key, time.time() - t0)
        refreshes = []
        for k, delta_dir in enumerate(delta_dirs, start=1):
            delta = _lineitem_delta(delta_dir)
            seen = set(scheduler.jobs)
            inc0 = scheduler.serving.snapshot()["incremental"]
            before = dict(ck.LAUNCHES)
            pushed = {}

            def append_and_drain():
                t1 = time.time()
                ctx.append("lineitem", delta)
                t_ret = time.time()
                for name, (_ps, sub, _key, _s) in subs.items():
                    tbl = sub.next(timeout=300)
                    pushed[name] = (tbl, time.time() - t_ret)
                return t_ret - t1

            busy = traced_wall = None
            if k == len(delta_dirs) and busy_ok:
                t1 = time.time()
                append_s = []
                busy = device_busy_ms(lambda: append_s.append(append_and_drain()))
                traced_wall = time.time() - t1
                append_s = append_s[0]
            else:
                append_s = append_and_drain()
            inc = scheduler.serving.snapshot()["incremental"]
            jobs = _jobs_since(scheduler, seen)
            rec = {"delta": k, "delta_rows": delta.num_rows, "append_s": append_s,
                   "kernel_launches": {n: ck.LAUNCHES[n] - before[n] for n in before
                                       if ck.LAUNCHES[n] - before[n]},
                   "jobs": len(jobs), "device_busy_ms": busy, "traced_wall_s": traced_wall,
                   "maintained": inc["maintained"] - inc0["maintained"],
                   "recomputes": inc["recomputes"] - inc0["recomputes"]}
            for name, (_ps, _sub, key, _s) in subs.items():
                tbl, latency = pushed[name]
                compare_answers(tbl, ORACLE.keyed(("serving", name, k))[0], f"{name} delta {k}")
                mode = inc["modes"].get(key, {})
                mine = [j for j in jobs if ("orders" in _job_tables(j)) == (name == "q12_join")]
                device = _job_device(mine)
                on_card = any(d[1] for kind, d in device.items() if kind == "TpuStageExec")
                if any(d[2] for d in device.values()):
                    raise AssertionError(f"{name} refresh {k}: a device stage fell back: {device}")
                rec[name] = {"incremental_mode": mode.get("mode"),
                             "incremental_reason": mode.get("reason"),
                             "append_to_push_s": latency, "device_nodes": device,
                             "delta_stage_on_card": on_card}
            if rec["maintained"] < len(subs):
                raise AssertionError(f"refresh {k}: {rec['maintained']} maintained of {len(subs)}")
            refreshes.append(rec)
            log(f"refresh {k} ({delta.num_rows} rows): " + "; ".join(
                f"{n} {rec[n]['incremental_mode']} push {rec[n]['append_to_push_s']:.4f}s "
                f"on card {rec[n]['delta_stage_on_card']}" for n in subs))
        snap = scheduler.subscriptions.snapshot()
        for _ps, sub, _key, _s in subs.values():
            try:
                extra = sub._sub.queue.get_nowait()
                raise AssertionError(f"an unexpected push: {extra.get('job_id')}")
            except queue.Empty:
                pass
    finally:
        for ps, sub, _key, _s in subs.values():
            sub.close()
            ps.close()
        ctx.shutdown()
    return {"query": "serving_subscriptions", "refreshes": refreshes,
            "first_push_s": {n: v[3] for n, v in subs.items()}, "subscriptions": snap}


def _job_tables(job) -> set:
    """The tables a job's stages scan."""
    from ballista_tpu_torch.serving.normalize import collect_scan_tables

    out: set = set()
    for st in job.stages.values():
        # a graph's stage holds its plan; a fast-lane job's view, its spec's
        plan = getattr(st, "plan", None) or getattr(getattr(st, "spec", None), "plan", None)
        if plan is not None:
            out |= collect_scan_tables(plan)
    return out


def _direct_cell(q4_dir: str) -> dict:
    """(c): DirectDispatcher over LocalLeaseTransport on a standalone
    cluster's executor on the card: DIRECT_PARAMS direct, each equal to the
    graph path (execute_prepared) and to engine=cpu (rows sorted); the lease
    revoked, the next execution demoted and equal; a fresh lease direct."""
    from ballista_tpu_torch.client.context import SessionContext, fetch_job_results
    from ballista_tpu_torch.client.direct import DirectDispatcher, LocalLeaseTransport
    from ballista_tpu_torch.config import BallistaConfig
    from ballista_tpu_torch.testing.tpchgen import register_tpch

    ctx = SessionContext.standalone(BallistaConfig(dict(SERVING_CONFIG)), num_executors=1,
                                    vcores=4)
    try:
        register_tpch(ctx, q4_dir)
        cluster = ctx._ensure_cluster()
        scheduler = cluster.scheduler
        sid = scheduler.sessions.create_or_update(ctx.config.to_key_value_pairs(),
                                                  str(ctx.session_id))
        d = DirectDispatcher(scheduler, LocalLeaseTransport(cluster.executors), sid, slots=1)
        d.prepare(DIRECT_SQL)
        runs = []

        def one(params, want_direct: bool) -> dict:
            t0 = time.time()
            st = d.execute(params)
            tbl = _sorted_rows(fetch_job_results(st, ctx.config))
            wall = time.time() - t0
            if bool(st.get("direct_dispatch")) != want_direct:
                raise AssertionError(f"direct {params}: direct_dispatch={st.get('direct_dispatch')}")
            want = _sorted_rows(ORACLE.keyed(("serving", "direct", params[0]))[0])
            if not tbl.equals(want):
                raise AssertionError(f"direct {params}: not the engine=cpu answer")
            return {"params": list(params), "path": "direct" if want_direct else "demoted",
                    "wall_s": wall, "rows_out": tbl.num_rows, "table": tbl}

        for params in DIRECT_PARAMS:
            r = one(params, True)
            t0 = time.time()
            jid = scheduler.execute_prepared(d.statement_id, params, session_id=sid)
            st = scheduler.wait_for_job(jid, timeout=300)
            graph = _sorted_rows(fetch_job_results(st, ctx.config))
            r["graph_wall_s"] = time.time() - t0
            if not graph.equals(r.pop("table")):
                raise AssertionError(f"direct {params}: not byte-equal to the graph path")
            runs.append(r)
        lease = d._lease
        if not scheduler.revoke_executor_lease(lease.lease_id):
            raise AssertionError("the lease was not revoked")
        d._lease = lease.clone()  # the client's copy still looks valid
        d._lease.revoked = False
        d._lease.expires_at = time.time() + 60
        for want_direct in (False, True):
            r = one(DIRECT_PARAMS[0], want_direct)
            r.pop("table")
            runs.append(r)
        stats = dict(d.stats)
        scheduler.revoke_executor_lease(d._lease.lease_id)
        leases = scheduler.leases.snapshot()
    finally:
        ctx.shutdown()
    log(f"direct dispatch: {[(r['path'], round(r['wall_s'], 4)) for r in runs]}, {stats}")
    return {"query": "serving_direct", "runs": runs, "dispatcher": stats, "leases": leases,
            "device_stage": False}


def _remote_serving_cell(q4_dir: str, delta_dirs: list) -> dict:
    """(d): an in-process SchedulerProcess and one ExecutorProcess at
    engine=tpu pinned to card 0 (one slot; the Python Flight server, which
    serves the lease actions): (a)'s q4 prepared with A and B, one append
    of the first delta's head with q1_count's subscription pushing, and
    DirectDispatcher over FlightLeaseTransport for two executions."""
    import shutil

    from ballista_tpu_torch.client.context import SessionContext, fetch_job_results
    from ballista_tpu_torch.client.direct import DirectDispatcher, FlightLeaseTransport
    from ballista_tpu_torch.config import BallistaConfig
    from ballista_tpu_torch.executor.executor_process import ExecutorProcess
    from ballista_tpu_torch.ops.cuda import cuda_kernels as ck
    from ballista_tpu_torch.scheduler.process import SchedulerProcess
    from ballista_tpu_torch.testing.standalone_stats import last_job
    from ballista_tpu_torch.testing.tpchgen import register_tpch

    sched = SchedulerProcess(bind_host="127.0.0.1", port=0, rest_port=-1, flight_proxy_port=-1)
    sched.start()
    addr = f"127.0.0.1:{sched.port}"
    work = os.path.join(REMOTE_DIR, "serving")
    shutil.rmtree(work, ignore_errors=True)
    ex = transport = sub = None
    out = {"query": "serving_remote"}
    try:
        ex = ExecutorProcess(addr, bind_host="127.0.0.1", external_host="127.0.0.1",
                             engine="tpu", device_ordinal=0, flight_impl="python", work_dir=work)
        ex.start()
        cfg = {**SERVING_CONFIG, "ballista.serving.result.cache.enabled": True}
        ctx = SessionContext.remote(addr, BallistaConfig(cfg))
        register_tpch(ctx, q4_dir)
        stmt = next(s for s in serving_statements() if s[0] == "q4")
        ps = ctx.prepare(stmt[1])
        execs = []
        for tag, text in (("a", stmt[1]), ("b", stmt[2])):
            before = dict(ck.LAUNCHES)
            t0 = time.time()
            tbl = ps.execute(_lift_values(ctx, text))
            wall = time.time() - t0
            compare_answers(tbl, ORACLE.keyed(("serving", "q4", tag))[0], f"q4 remote {tag}")
            device = _job_device([last_job(sched.scheduler)])
            _hold_device(f"q4 remote {tag}", device)
            if ck.LAUNCHES["masked_group_reduce"] - before["masked_group_reduce"] < 1:
                raise AssertionError(f"q4 remote {tag}: no masked_group_reduce launch")
            execs.append({"params": tag, "wall_s": wall, "device_nodes": device})
        ps.close()
        out["q4"] = execs
        sps = ctx.prepare(Q1_COUNT_SQL)
        sub = sps.subscribe()
        compare_answers(sub.next(timeout=300), ORACLE.keyed(("serving", "q1_count", 0))[0],
                        "q1_count remote base")
        delta = _lineitem_delta(delta_dirs[0], SERVING_SMALL_DELTA_ROWS)
        ctx.append("lineitem", delta)
        t_ret = time.time()
        pushed = sub.next(timeout=300)
        out["append_to_push_s"] = time.time() - t_ret
        compare_answers(pushed, ORACLE.keyed(("serving", "q1_count", "small_delta"))[0],
                        "q1_count remote delta")
        inc = sched.scheduler.serving.snapshot()["incremental"]
        out["delta_rows"], out["maintained"] = delta.num_rows, inc["maintained"]
        out["incremental_modes"] = list(inc["modes"].values())
        sub.close()
        sub = None
        sps.close()
        scheduler = sched.scheduler
        sid = scheduler.sessions.create_or_update(ctx.config.to_key_value_pairs(),
                                                  "serving-direct")
        transport = FlightLeaseTransport()
        d = DirectDispatcher(scheduler, transport, sid, slots=1)
        d.prepare(DIRECT_SQL)
        # the lease takes the executor's one slot: wait for the last job's
        # task status to hand it back
        deadline = time.time() + 30
        while not any(e.free_slots for e in scheduler.executors.alive_executors()):
            if time.time() > deadline:
                raise AssertionError("the executor's slot never came back")
            time.sleep(0.05)
        direct = []
        for params in DIRECT_PARAMS[:2]:
            t0 = time.time()
            st = d.execute(params)
            tbl = _sorted_rows(fetch_job_results(st, ctx.config))
            if not st.get("direct_dispatch"):
                raise AssertionError(f"remote direct {params}: demoted ({d.stats})")
            if not tbl.equals(_sorted_rows(ORACLE.keyed(("serving", "direct", params[0]))[0])):
                raise AssertionError(f"remote direct {params}: not the engine=cpu answer")
            direct.append({"params": list(params), "wall_s": time.time() - t0})
        scheduler.revoke_executor_lease(d._lease.lease_id)
        out["direct"] = direct
        out["dispatcher"] = dict(d.stats)
        out["lease_dispatch_rpcs"] = ex.flight_server.stats["lease_dispatch"]
    finally:
        if sub is not None:
            sub.close()
        if transport is not None:
            transport.close()
        if ex is not None:
            ex.shutdown()
            shutil.rmtree(work, ignore_errors=True)
        sched.shutdown()
    log(f"remote serving: q4 {[round(e['wall_s'], 4) for e in out['q4']]}, push "
        f"{out['append_to_push_s']:.4f}s, direct {[round(r['wall_s'], 4) for r in out['direct']]}")
    return out


def serving_phase(q4_dir: str, delta_dirs: list, busy_ok: bool, launches: dict,
                  emit) -> None:
    """Phase 12: (a) prepared statements, local and standalone; (b)
    continuous queries; (c) direct dispatch; (d) the remote mode. The
    launch counts are set to 0 just before each part and read just after
    it, into `launches`."""
    from ballista_tpu_torch.client.context import SessionContext
    from ballista_tpu_torch.config import BallistaConfig
    from ballista_tpu_torch.ops.cuda import cuda_kernels as ck
    from ballista_tpu_torch.testing.tpchgen import register_tpch

    stmts = serving_statements()
    for mode in ("local", "standalone"):
        ck.reset_launches()
        for stmt in stmts:
            cfg = BallistaConfig({**SERVING_CONFIG, **stmt[3]})
            ctx = (SessionContext.standalone(cfg, num_executors=1, vcores=4)
                   if mode == "standalone" else SessionContext(cfg))
            try:
                register_tpch(ctx, q4_dir)
                scheduler = ctx._ensure_cluster().scheduler if mode == "standalone" else None
                r = _prepared_cell(mode, ctx, stmt, scheduler, busy_ok)
            finally:
                ctx.shutdown()
            emit(r)
        launches[f"serving_{mode}"] = dict(ck.LAUNCHES)
        for kernel in ("masked_group_reduce", "hash_probe", "dict_filter"):
            if ck.LAUNCHES[kernel] < 1:
                raise AssertionError(f"serving {mode}: {kernel} never launched")
    for key, cell in (("serving_subscriptions", lambda: _subscriptions_cell(
                          q4_dir, delta_dirs, busy_ok)),
                      ("serving_direct", lambda: _direct_cell(q4_dir)),
                      ("serving_remote", lambda: _remote_serving_cell(q4_dir, delta_dirs))):
        ck.reset_launches()
        r = cell()
        r["launches"] = launches[key] = dict(ck.LAUNCHES)
        emit(r)


# ---------------------------------------------------------------- main

# phase 13: the SQL CLI as a process on the card, at --q4-scale. Every CLI
# file opens with the settings phases 4-6 run under, as SET statements; (a)
# is remote, against an in-process cluster whose executor this process
# counts the launches of; (b) the CLI's default standalone mode
CLI_DIR = os.path.join(ROOT, "build", "cli")  # the CLI's statement files
CLI_TABLES = ("customer", "orders", "lineitem", "supplier", "nation", "region")
CLI_REMOTE = (4, 5, "fused_pallas", 12)
# the kernel (a) must launch, with its least count, over the file's runs
CLI_KERNELS = {"masked_group_reduce": 1, "hash_probe": 2, "dict_filter": 1}
CLI_TIMEOUT_S = 240


def _cli_statements(data_dir: str, tables, items) -> list:
    """(statement, kind) pairs: kind "set", "create", a query number, or
    ("explain", q)."""
    out = [(f"SET {k} = {str(v).lower()};", "set") for k, v in QUERY_CONFIG.items()
           if k != "ballista.executor.engine"]
    out += [(f"CREATE EXTERNAL TABLE {t} STORED AS PARQUET "
             f"LOCATION '{os.path.join(data_dir, t)}';", "create") for t in tables]
    for it in items:
        if it == "fused_pallas":
            out.append(("SET ballista.tpu.fusion.mode = fused_pallas;", "set"))
        elif isinstance(it, tuple):
            out.append(("EXPLAIN ANALYZE " + _query_sql(it[1]).strip(), it))
        else:
            out.append((_query_sql(it).strip(), it))
    return out


def _run_cli(name: str, args: list, statements: list) -> dict:
    """Run the CLI as a process over `statements` (one file); fails on a
    nonzero exit, an `Error:` line, or a statement that printed no Elapsed.
    Returns each statement's printed block and Elapsed, and the wall."""
    import re

    os.makedirs(CLI_DIR, exist_ok=True)
    path = os.path.join(CLI_DIR, f"{name}.sql")
    with open(path, "w") as f:
        f.write("\n".join(stmt for stmt, _ in statements) + "\n")
    env = {k: v for k, v in os.environ.items() if k != "BALLISTA_TORCH_PLATFORM"}
    t = time.time()
    p = subprocess.run([sys.executable, "-m", "ballista_tpu_torch.cli", "--engine", "tpu",
                        *args, "-f", path], capture_output=True, text=True,
                       timeout=CLI_TIMEOUT_S, cwd=ROOT, env=env)
    wall = time.time() - t
    with open(os.path.join(CLI_DIR, f"{name}.stderr"), "w") as f:
        f.write(p.stderr)
    errors = [ln for ln in p.stderr.splitlines() if ln.startswith("Error:")]
    if p.returncode != 0 or errors:
        raise AssertionError(f"cli {name}: exit {p.returncode}, {errors[:3]}; "
                             f"stderr tail {p.stderr[-2000:]}")
    elapsed = re.compile(r"^Elapsed (\d+\.\d+) seconds\.$")
    blocks, cur = [], []
    for ln in p.stdout.splitlines():
        m = elapsed.match(ln)
        if m:
            blocks.append(("\n".join(cur), float(m.group(1))))
            cur = []
        else:
            cur.append(ln)
    if len(blocks) != len(statements):
        raise AssertionError(f"cli {name}: {len(blocks)} statements printed an Elapsed "
                             f"line of {len(statements)}; stdout tail {p.stdout[-2000:]}")
    return {"blocks": blocks, "wall_s": round(wall, 3)}


def _same_printed(got: str, want: str, label: str) -> None:
    """The CLI's printed answer against the engine=cpu answer printed the
    same way: ints and strings exact, floats within rtol 1e-9 as printed."""
    import math

    g, w = got.splitlines(), want.splitlines()
    if len(g) != len(w):
        raise AssertionError(f"{label}: {len(g)} printed lines != {len(w)}:\n{got}\n--\n{want}")
    for a, b in zip(g, w):
        ta, tb = a.split(), b.split()
        if len(ta) != len(tb):
            raise AssertionError(f"{label}: {a!r} != {b!r}")
        for x, y in zip(ta, tb):
            if x == y:
                continue
            try:
                fx, fy = float(x), float(y)
            except ValueError:
                raise AssertionError(f"{label}: {a!r} != {b!r}") from None
            ints = x.lstrip("-").isdigit() and y.lstrip("-").isdigit()
            if ints or not math.isclose(fx, fy, rel_tol=1e-9):
                raise AssertionError(f"{label}: {x} != {y} in {a!r}")


def _hold_cli_answers(name: str, statements: list, run: dict, answers: dict) -> dict:
    from ballista_tpu_torch.cli.main import format_table

    out = {}
    for (stmt, kind), (text, el) in zip(statements, run["blocks"]):
        if isinstance(kind, int):
            _same_printed(text, format_table(answers[kind]), f"cli {name} q{kind}")
            out[f"q{kind}"] = el
    return out


def _device_nodes_of(text: str) -> list:
    """(node, device_runs, cpu_fallbacks) for every device node of an
    EXPLAIN ANALYZE the CLI printed."""
    import re

    return [(n, int(r), int(f)) for n, r, f in re.findall(
        r"(Tpu\w+Exec): .*? device_runs=(\d+) cpu_fallbacks=(\d+)", text)]


def cli_phase(q4_dir: str, answers: dict, launches: dict) -> list:
    """Phase 13; `answers`: the engine=cpu answer tables of q4, q5 and q12
    at --q4-scale. Sets launches["cli_remote"]."""
    from ballista_tpu_torch.cli import tui
    from ballista_tpu_torch.ops.cuda import cuda_kernels

    recs = []
    # (a) remote: the CLI's statements run in this process's executor
    stmts = _cli_statements(q4_dir, CLI_TABLES, CLI_REMOTE)
    cluster = start_remote_cluster()
    sched = cluster[0]
    try:
        cuda_kernels.reset_launches()
        run = _run_cli("remote", ["--host", "127.0.0.1", "--port", str(sched.port)], stmts)
        counts = launches["cli_remote"] = dict(cuda_kernels.LAUNCHES)
        probes = _probe_launches()
        for k, least in CLI_KERNELS.items():
            if counts[k] < least:
                raise AssertionError(f"cli remote: {k} launched {counts[k]} times, "
                                     f"fewer than {least}")
        elapsed = _hold_cli_answers("remote", stmts, run, answers)
        rec = {"query": "cli_remote", "statements": len(stmts), "elapsed_s": elapsed,
               "wall_s": run["wall_s"], "launches": counts, "hash_probe_launches": probes}
        recs.append(rec)
        log(f"cli remote: {elapsed}, wall {run['wall_s']} s, launches {counts}")
        # (c) the TUI over the same scheduler's REST: one headless frame
        client = tui.RestClient(f"http://127.0.0.1:{sched.rest_port}")
        state, jobs, execs = client.state(), client.jobs(), client.executors()
        hist = tui.History()
        hist.sample(jobs, execs)
        jobs = tui.sort_jobs(jobs, "queued")
        frame = (tui.render_header(state, hist) + tui.render_jobs(jobs, 0)
                 + tui.render_executors(execs, 0))
        for j in jobs:
            stages = client.stages(j["job_id"])
            if j["state"] != "successful" or not stages or \
                    any(s["state"] != "successful" for s in stages):
                raise AssertionError(f"tui: job {j['job_id']} {j['state']}, stages "
                                     f"{[(s['stage_id'], s['state']) for s in stages]}")
            frame += tui.render_stages(stages)
        # the remote client submits every statement as a job, SET and
        # CREATE EXTERNAL TABLE too
        listed = [j["job_id"] for j in jobs if any(j["job_id"][:12] in ln for ln in frame)]
        if len(jobs) != len(stmts) or len(listed) != len(stmts):
            raise AssertionError(f"tui: {len(jobs)} jobs, {len(listed)} listed, "
                                 f"{len(stmts)} statements ran")
        for ln in frame:
            log(f"tui | {ln}")
        recs.append({"query": "cli_tui", "jobs": len(jobs),
                     "query_jobs": sum(1 for j in jobs if j["total_stages"] > 1),
                     "frame_lines": len(frame), "frame": frame})
    finally:
        stop_remote_cluster(sched, cluster[2])
    # (b) the CLI's default standalone mode, in its own process
    stmts = _cli_statements(q4_dir, ("orders", "lineitem"), (4, ("explain", 4)))
    run = _run_cli("standalone", [], stmts)
    elapsed = _hold_cli_answers("standalone", stmts, run, answers)
    nodes = _device_nodes_of(run["blocks"][-1][0])
    kinds = {n for n, _r, _f in nodes}
    if not {"TpuStageExec", "TpuFinalStageExec"} <= kinds or \
            any(r < 1 or f != 0 for _n, r, f in nodes):
        raise AssertionError(f"cli standalone: EXPLAIN ANALYZE device nodes {nodes}")
    elapsed["explain_analyze_q4"] = run["blocks"][-1][1]
    recs.append({"query": "cli_standalone", "statements": len(stmts), "elapsed_s": elapsed,
                 "wall_s": run["wall_s"], "device_nodes": len(nodes),
                 "device_runs": sum(r for _n, r, _f in nodes),
                 "cpu_fallbacks": sum(f for _n, _r, f in nodes)})
    log(f"cli standalone: {elapsed}, wall {run['wall_s']} s, {len(nodes)} device nodes "
        f"without fallback")
    return recs


# ---------------------------------------------------------------- mesh

MESH_QUERIES = (1, 3, 4, 13)  # phase 14 (c): standalone at --q4-scale
MESH_SHARDS = 4  # (a), (b), (e): the one card as 4 shards, Mesh([cuda:0] * 4)


def submit_mesh_oracle(data_dir: str) -> None:
    """The engine=cpu answers phase 14 (c) holds its runs to."""
    for q in MESH_QUERIES:
        ORACLE._submit(("mesh", q, data_dir), _oracle_job, _query_sql(q), data_dir)


@contextlib.contextmanager
def _captured_exchanges(into: list):
    """Record every MeshExchangeExec's node and producer partitions as its
    ladder receives them (the real producer output of a merged stage)."""
    from ballista_tpu_torch.ops.cuda.mesh_stage import MeshExchangeExec

    ladder = MeshExchangeExec._try_device_exchange

    def spy(self, part_tables, ctx, rec):
        into.append((self, part_tables))
        return ladder(self, part_tables, ctx, rec)

    MeshExchangeExec._try_device_exchange = spy
    try:
        yield
    finally:
        MeshExchangeExec._try_device_exchange = ladder


def _shuffle_dirs(work_dir: str, job_id: str) -> set:
    path = os.path.join(work_dir, job_id)
    return {int(d) for d in os.listdir(path) if d.isdigit()} if os.path.isdir(path) else set()


def _mesh_standalone(q: int, data_dir: str, mesh: bool, runs: int) -> dict:
    """q through SessionContext.standalone(num_executors=1, vcores=4) with
    ballista.tpu.mesh.enabled = `mesh`: `runs` runs (the first cold), each
    run's wall, kernel launches, stages and tasks, the stages that wrote
    shuffle files, the mesh stats; the producers the exchange received."""
    from ballista_tpu_torch.client.context import SessionContext
    from ballista_tpu_torch.config import BallistaConfig
    from ballista_tpu_torch.ops.cuda import cuda_kernels as ck
    from ballista_tpu_torch.ops.cuda.stage_compiler import RUN_STATS
    from ballista_tpu_torch.testing.standalone_stats import last_job, stage_stats
    from ballista_tpu_torch.testing.tpchgen import register_tpch

    sql = _query_sql(q)
    ctx = SessionContext.standalone(
        BallistaConfig({**QUERY_CONFIG, "ballista.tpu.mesh.enabled": mesh}),
        num_executors=1, vcores=4)
    out = {"walls": [], "launches": [], "exchanges": []}
    try:
        register_tpch(ctx, data_dir)
        cluster = ctx._ensure_cluster()
        for _ in range(runs):
            RUN_STATS.clear()
            before = dict(ck.LAUNCHES)
            t0 = time.time()
            with _captured_exchanges(out["exchanges"]):
                out["table"] = ctx.sql(sql).collect()
            out["walls"].append(time.time() - t0)
            out["launches"].append({k: ck.LAUNCHES[k] - before[k] for k in before})
            graph = last_job(cluster.scheduler)
            out["stats"] = stage_stats(graph)
            out["mesh_stages"] = [sid for sid, st in graph.stages.items() if st.spec.mesh]
            out["dirs"] = _shuffle_dirs(cluster.work_dir, graph.job_id)
            out["run_stats"] = {k: RUN_STATS.snapshot().get(k) for k in (
                "mesh_mode_reason", "mesh_devices", "exchange_s", "exchange_bytes_on_device")}
    finally:
        ctx.shutdown()
    return out


def _mesh_cell(q: int, data_dir: str, cpu_tbl) -> tuple[dict, list, dict]:
    """Phase 14 (c) for one query: the mesh-off run, then two mesh runs
    (cold, warm), held. Returns the record, the producers the merged
    stage's exchange received, and the mesh runs' summed launches."""
    off = _mesh_standalone(q, data_dir, False, 1)
    on = _mesh_standalone(q, data_dir, True, 2)
    label = f"mesh q{q}"
    compare_answers(off["table"], cpu_tbl, f"{label} (mesh off)")
    compare_answers(on["table"], cpu_tbl, label)
    if not on["table"].equals(off["table"]):
        raise AssertionError(f"{label}: the answer differs from the mesh-off run's bytes")
    if len(on["stats"]) >= len(off["stats"]) or len(on["mesh_stages"]) != 1:
        raise AssertionError(f"{label}: stages {sorted(on['stats'])} (merged "
                             f"{on['mesh_stages']}) against {sorted(off['stats'])} mesh off")
    merged = on["mesh_stages"][0]
    if on["stats"][merged]["tasks"] != 1:
        raise AssertionError(f"{label}: the merged stage ran {on['stats'][merged]['tasks']} tasks")
    reason = on["run_stats"]["mesh_mode_reason"]
    if reason != "demoted:single-device":
        raise AssertionError(f"{label}: mesh_mode_reason {reason!r} on one card")
    for run in (on, off):
        for sid, st in run["stats"].items():
            if st["fallbacks"]:
                raise AssertionError(f"{label}: stage {sid} fell back ({st['device']})")
    if not any(k == "TpuStageExec" for k in on["stats"][merged]["device"]):
        raise AssertionError(f"{label}: the merged stage's producer ran no device stage "
                             f"({on['stats'][merged]['device']})")
    gone = set(off["stats"]) - set(on["stats"])
    if not gone or not gone <= off["dirs"] or gone & on["dirs"]:
        raise AssertionError(f"{label}: the fused edge's stages {sorted(gone)} wrote files "
                             f"(mesh on {sorted(on['dirs'])}, off {sorted(off['dirs'])})")
    launches = {k: sum(r[k] for r in on["launches"]) for k in on["launches"][0]}
    if q == 4 and min(r["masked_group_reduce"] for r in on["launches"]) < 1:
        raise AssertionError(f"{label}: the producer launched no masked_group_reduce "
                             f"({on['launches']})")
    rec = {
        "query": f"mesh_q{q}", "mesh_cold_wall_s": on["walls"][0], "mesh_wall_s": on["walls"][1],
        "off_wall_s": off["walls"][0], "stages": len(on["stats"]),
        "off_stages": len(off["stats"]), "merged_stage": merged,
        "merged_stage_device_nodes": on["stats"][merged]["device"],
        "fused_edge_stages": sorted(gone), **on["run_stats"],
        "kernel_launches_per_run": on["launches"],
    }
    return rec, on["exchanges"][-1], launches


def _exchange_inputs(node, part_tables, n: int):
    """(row hashes as int64, [row id, each column's lanes], live) of a
    producer's output, padded to a multiple of n: what _device_exchange
    ships."""
    import numpy as np
    import pyarrow as pa

    from ballista_tpu_torch.ops.cuda.mesh_stage import _encode_column

    combined = pa.concat_tables(part_tables).combine_chunks()
    rows = combined.num_rows
    padded = rows + (-rows) % n

    def pad(a, fill=0):
        out = np.full(padded, fill, dtype=a.dtype)
        out[:rows] = a
        return out

    lanes = [pad(np.arange(rows, dtype=np.int64))]
    for name in combined.column_names:
        col_lanes, _valid, _meta = _encode_column(combined.column(name))
        lanes.extend(pad(l) for l in col_lanes)
    h = node._row_hashes(combined)
    return pad(h.view(np.int64)), lanes, pad(np.ones(rows, dtype=bool), False)


def _same_out(card_outs, cpu_outs, label: str) -> None:
    import numpy as np

    for i, (g, w) in enumerate(zip(card_outs, cpu_outs)):
        g, w = np.asarray(g), np.asarray(w)
        if g.dtype != w.dtype or g.shape != w.shape or not (g == w).all():
            raise AssertionError(f"{label}: output {i} differs from the CPU form")


def _rows_per_device(rowid, ok, n: int) -> list:
    per_id, per_ok = rowid.reshape(n, -1), ok.reshape(n, -1)
    return [per_id[j][per_ok[j]] for j in range(n)]


def exchange_check(captured: dict, data_dir: str, dev) -> dict:
    """Phase 14 (a): hash_exchange_table on q13's and q4's producer output,
    hash_exchange_all_to_all on lineitem's l_orderkey, partial_then_psum on
    l_quantity, each over MESH_SHARDS shards of the card: the same outputs
    as their CPU form bit for bit, every valid row on shard hash % 4 in row
    order, and CUDA-event times."""
    import numpy as np
    import pyarrow.parquet as pq
    import torch

    from ballista_tpu_torch.ops.hashing import splitmix64
    from ballista_tpu_torch.parallel.exchange import (
        Mesh,
        hash_exchange_all_to_all,
        hash_exchange_table,
        partial_then_psum,
        required_exchange_capacity,
    )

    n = MESH_SHARDS
    card, cpu = Mesh([dev] * n), Mesh([torch.device("cpu")] * n)
    rec: dict = {"shards": n}
    for q in (13, 4):
        node, parts = captured[q]
        h, lanes, live = _exchange_inputs(node, parts, n)
        local = len(h) // n
        cap = max(1, required_exchange_capacity(
            [h[d * local:(d + 1) * local][live[d * local:(d + 1) * local]].view(np.uint64)
             for d in range(n)], n, prehashed=True))
        h_d, lanes_d, live_d = card.shard(h), [card.shard(l) for l in lanes], card.shard(live)
        outs = hash_exchange_table(h_d, lanes_d, live_d, card, capacity=cap)
        flat = [outs[0], *outs[1], outs[2]]
        ref = hash_exchange_table(h, lanes, live, cpu, capacity=cap)
        _same_out(flat, [ref[0], *ref[1], ref[2]], f"hash_exchange_table q{q}")
        ok = np.asarray(outs[2])
        dest = h.view(np.uint64) % np.uint64(n)
        got = _rows_per_device(np.asarray(outs[1][0]), ok, n)
        for j in range(n):
            want = np.nonzero(live & (dest == j))[0]
            if not np.array_equal(got[j], want):
                raise AssertionError(f"hash_exchange_table q{q}: shard {j} holds other rows "
                                     "than hash_arrays % 4 routes there")
        ms = cuda_ms(lambda: hash_exchange_table(h_d, lanes_d, live_d, card, capacity=cap), 5,
                     warmup=1)
        rec[f"table_q{q}"] = {"rows": int(live.sum()), "lanes": len(lanes) + 2,
                              "capacity": cap, "ms": ms}
        log(f"mesh (a) hash_exchange_table q{q}: {int(live.sum())} rows, {len(lanes) + 2} "
            f"lanes, capacity {cap}: {ms:.4f} ms, equal to the CPU form and hash % {n}")

    li = pq.read_table(os.path.join(data_dir, "lineitem"), columns=["l_orderkey", "l_quantity"])
    rows = li.num_rows - li.num_rows % n
    keys = li.column("l_orderkey").to_numpy()[:rows].astype(np.int64)
    rowid = np.arange(rows, dtype=np.int64)
    local = rows // n
    cap = required_exchange_capacity([keys[d * local:(d + 1) * local] for d in range(n)], n)
    k_d, r_d = card.shard(keys), card.shard(rowid)
    outs = hash_exchange_all_to_all(k_d, r_d, card, capacity=cap)
    _same_out(outs, hash_exchange_all_to_all(keys, rowid, cpu, capacity=cap),
              "hash_exchange_all_to_all")
    dest = splitmix64(keys.astype(np.uint64)) % np.uint64(n)
    got = _rows_per_device(np.asarray(outs[1]), np.asarray(outs[2]), n)
    for j in range(n):
        if not np.array_equal(got[j], np.nonzero(dest == j)[0]):
            raise AssertionError(f"hash_exchange_all_to_all: shard {j} holds other rows "
                                 "than splitmix64(l_orderkey) % 4 routes there")
    ms = cuda_ms(lambda: hash_exchange_all_to_all(k_d, r_d, card, capacity=cap), 5, warmup=1)
    rec["all_to_all_l_orderkey"] = {"rows": rows, "capacity": cap, "ms": ms}
    log(f"mesh (a) hash_exchange_all_to_all l_orderkey: {rows} rows, capacity {cap}: "
        f"{ms:.4f} ms, equal to the CPU form and splitmix64 % {n}")

    qty = li.column("l_quantity").to_numpy()[:rows].astype(np.float64)

    def groups(v):
        return torch.stack([(v // 13) == g for g in range(4)])

    q_d = card.shard(qty)
    sums, cnts = partial_then_psum(q_d, groups, 4, card)
    csums, ccnts = partial_then_psum(qty, groups, 4, cpu)
    _same_out([cnts], [ccnts], "partial_then_psum counts")
    g = qty // 13
    want_s = np.array([qty[g == k].sum() for k in range(4)])
    want_c = np.array([(g == k).sum() for k in range(4)])
    # integer quantities: every partial and total is exact in float64
    if not (np.asarray(sums) == want_s).all() or not (np.asarray(cnts) == want_c).all() \
            or not (np.asarray(csums) == want_s).all():
        raise AssertionError(f"partial_then_psum: {np.asarray(sums)} / {np.asarray(cnts)} "
                             f"against {want_s} / {want_c}")
    ms = cuda_ms(lambda: partial_then_psum(q_d, groups, 4, card), 5, warmup=1)
    rec["partial_then_psum_l_quantity"] = {"rows": rows, "groups": 4, "ms": ms}
    log(f"mesh (a) partial_then_psum l_quantity: {rows} rows, 4 groups: {ms:.4f} ms")
    return rec


def device_exchange_check(captured: dict, dev) -> dict:
    """Phase 14 (b): MeshExchangeExec._device_exchange over MESH_SHARDS
    shards of the card on q3's (a date column, C25) and q13's producers,
    byte-identical to _host_split."""
    import torch

    from ballista_tpu_torch.parallel.exchange import Mesh

    mesh = Mesh([dev] * MESH_SHARDS)
    rec: dict = {}
    for q in (3, 13):
        node, parts = captured[q]
        host = node._host_split(parts)
        stats: dict = {}
        walls = []
        for _ in range(2):
            t0 = time.time()
            buckets = node._device_exchange(parts, mesh, 1 << 20, stats)
            torch.cuda.synchronize(dev)
            walls.append(time.time() - t0)
            if [[b.num_rows for b in bs] for bs in buckets] != \
                    [[b.num_rows for b in bs] for bs in host]:
                raise AssertionError(f"_device_exchange q{q}: bucket shapes differ "
                                     "from the host split")
            for p, (bs, hs) in enumerate(zip(buckets, host)):
                for x, y in zip(bs, hs):
                    if not (x.schema.equals(y.schema) and x.equals(y)):
                        raise AssertionError(f"_device_exchange q{q}: bucket {p} "
                                             "differs from the host split")
        types = sorted({str(f.type) for f in parts[0].schema})
        rec[f"q{q}"] = {"rows": sum(t.num_rows for t in parts), "types": types,
                        "cold_s": walls[0], "warm_s": walls[1], **stats}
        log(f"mesh (b) _device_exchange q{q}: {rec[f'q{q}']['rows']} rows {types}: "
            f"{walls[1]:.4f} s warm (exchange_s {stats.get('exchange_s')}), "
            "byte-identical to the host split")
    return rec


def collective_check(data_dir: str, dev, cpu_tbl) -> dict:
    """Phase 14 (d): local q1 with ballista.tpu.collective.exchange on. One
    visible card: _stage_mesh is None, and the claims, the answer and the
    cached table equal the run without it."""
    import torch

    from ballista_tpu_torch.client.context import SessionContext
    from ballista_tpu_torch.config import BallistaConfig
    from ballista_tpu_torch.engine.cuda_engine import maybe_compile_tpu
    from ballista_tpu_torch.ops.cuda import stage_compiler as sc
    from ballista_tpu_torch.testing.tpchgen import register_tpch

    sql = _query_sql(1)
    out = {}
    for coll in (False, True):
        cfg = BallistaConfig({**QUERY_CONFIG, "ballista.tpu.collective.exchange": coll})
        ctx = SessionContext(cfg)
        register_tpch(ctx, data_dir)
        physical = maybe_compile_tpu(ctx.create_physical_plan(ctx.sql(sql).plan), cfg)
        tbl = ctx.execute_collect(physical)
        compare_answers(tbl, cpu_tbl, "q1 collective" if coll else "q1")
        out[coll] = (tbl, device_claims(physical), sc._stage_mesh(cfg))
    if torch.cuda.device_count() == 1 and out[True][2] is not None:
        raise AssertionError(f"q1 collective: a stage mesh {out[True][2]} on one card")
    if not out[True][0].equals(out[False][0]) or out[True][1] != out[False][1]:
        raise AssertionError("q1 collective: the answer or the claims differ from the run "
                             f"without it ({out[True][1]} against {out[False][1]})")
    if any(dt.mesh is not None for dt in sc.DEVICE_CACHE._cache.values()):
        raise AssertionError("q1 collective: a table was sharded on one card")
    log(f"mesh (d) q1 with collective.exchange: no stage mesh on one card, claims "
        f"{out[True][1]} and answer as without it")
    return {"claims": out[True][1], "stage_mesh": None}


def sharded_pass_check(data_dir: str, dev) -> dict:
    """Phase 14 (e): q1's partial-aggregate stage handed a mesh of
    MESH_SHARDS shards of the card: its table sharded by partition, its
    pass run once per shard, every partition's output equal to the
    unsharded pass's bytes; warm passes timed on the host clock."""
    from ballista_tpu_torch.client.context import SessionContext
    from ballista_tpu_torch.config import BallistaConfig
    from ballista_tpu_torch.engine.cuda_engine import maybe_compile_tpu
    from ballista_tpu_torch.ops.cuda import stage_compiler as sc
    from ballista_tpu_torch.parallel.exchange import Mesh
    from ballista_tpu_torch.plan.physical import TaskContext
    from ballista_tpu_torch.testing.tpchgen import register_tpch

    mesh = Mesh([dev] * MESH_SHARDS)
    cfg = BallistaConfig(dict(QUERY_CONFIG))
    ctx = SessionContext(cfg)
    register_tpch(ctx, data_dir)
    outs, walls, kernel_s = {}, {}, {}
    for sharded in (False, True):
        physical = maybe_compile_tpu(ctx.create_physical_plan(ctx.sql(_query_sql(1)).plan), cfg)
        stage = next(n for n in _walk(physical) if isinstance(n, sc.TpuStageExec))
        if sharded:
            stage.stage_mesh = mesh
        tc = TaskContext(cfg)
        outs[sharded] = [list(stage.execute(p, tc)) for p in range(stage.output_partition_count())]
        if stage.tpu_count != 1 or stage.fallback_count:
            raise AssertionError(f"mesh (e): {stage.node_str()} did not run on the card")
        times = []
        for _ in range(3):
            t0 = time.time()
            stage._dispatch_all(tc)
            times.append(time.time() - t0)
        walls[sharded] = min(times)
        kernel_s[sharded] = sc.RUN_STATS.stages().get(_tag(stage), {}).get("fused_kernel_s")
    for p, (a, b) in enumerate(zip(outs[True], outs[False])):
        if [x.num_rows for x in a] != [x.num_rows for x in b] or \
                not all(x.equals(y) for x, y in zip(a, b)):
            raise AssertionError(f"mesh (e): partition {p} of the sharded pass differs")
    tables = [dt for dt in sc.DEVICE_CACHE._cache.values()
              if dt.mesh is not None and dt.mesh.key() == mesh.key()]
    if not tables:
        raise AssertionError("mesh (e): no table sharded over the 4 shards")
    dt = tables[-1]
    if not all(c.sharded and len(c.shards) == MESH_SHARDS for c in dt.cols):
        raise AssertionError("mesh (e): the cached table is not split 4 ways")
    log(f"mesh (e) q1's partial stage over {MESH_SHARDS} shards of the card: table "
        f"{list(dt.shape)}, every partition equal to the unsharded pass; warm pass "
        f"{walls[True]:.4f} s sharded, {walls[False]:.4f} s unsharded")
    return {"table_shape": list(dt.shape), "shards": MESH_SHARDS,
            "sharded_pass_s": walls[True], "unsharded_pass_s": walls[False],
            "sharded_fused_kernel_s": kernel_s[True],
            "unsharded_fused_kernel_s": kernel_s[False]}


def mesh_phase(data_dir: str, dev, launches: dict, emit) -> None:
    """Phase 14: (c) first, whose merged stages hand (a) and (b) their
    real producer output, then (a), (b), (d) and (e). The launch counts
    are set to 0 just before each query of (c) and read just after it."""
    from ballista_tpu_torch.ops.cuda import cuda_kernels as ck

    captured = {}
    for q in MESH_QUERIES:
        cpu_tbl, _cpu_s = ORACLE.keyed(("mesh", q, data_dir))
        ck.reset_launches()
        r, captured[q], _ = _mesh_cell(q, data_dir, cpu_tbl)
        launches[f"mesh_q{q}"] = dict(ck.LAUNCHES)
        emit(r)
        log(f"mesh (c) q{q}: {r['off_stages']} -> {r['stages']} stages, "
            f"{r['mesh_mode_reason']}, cold {r['mesh_cold_wall_s']:.3f} s, warm "
            f"{r['mesh_wall_s']:.3f} s (mesh off {r['off_wall_s']:.3f} s)")
    emit({"query": "mesh_exchange", **exchange_check(captured, data_dir, dev)})
    emit({"query": "mesh_device_exchange", **device_exchange_check(captured, dev)})
    emit({"query": "mesh_collective_q1",
          **collective_check(data_dir, dev, ORACLE.keyed(("mesh", 1, data_dir))[0])})
    emit({"query": "mesh_sharded_q1", **sharded_pass_check(data_dir, dev)})


# phase 15: the cold-path pipeline (ballista.tpu.compile.overlap, the
# join builds beside the probe fill; ballista.tpu.fill.chunk_rows, the
# pinned, chunked upload) and the object store (s3:// tables served by the
# port's in-process S3 shim), at --q4-scale. (a) per setting: (overlap,
# chunk_rows); reached late (LATE_AT), the first two only
COLD_SETTINGS = (("off", False, 0), ("on", True, 0), ("on_chunked", True, 1 << 18))
COLD_QUERIES = ((5, {}), (21, {"ballista.tpu.fusion.mode": "fused_pallas"}))
# (b): the s3:// queries with the kernel each run must launch; late, q4 alone
S3_QUERIES = ((4, {}, "masked_group_reduce"),
              (12, {"ballista.tpu.fusion.mode": "fused_pallas"}, "dict_filter"))
S3_TABLES = ("orders", "lineitem")
UDF_SQL = ("SELECT l_returnflag, sum(double_it(l_quantity)) AS s FROM lineitem "
           "GROUP BY l_returnflag ORDER BY l_returnflag")


def _device_stages(physical, label: str) -> list:
    """Every device stage of `physical`, each of which must have run on
    the card with no fallback."""
    from ballista_tpu_torch.ops.cuda.final_stage import TpuFinalStageExec
    from ballista_tpu_torch.ops.cuda.stage_compiler import TpuStageExec

    stages = [n for n in _walk(physical) if isinstance(n, (TpuStageExec, TpuFinalStageExec))]
    if not any(isinstance(s, TpuStageExec) for s in stages):
        raise AssertionError(f"{label}: no device partial stage was planned")
    for s in stages:
        if s.tpu_count < 1 or s.fallback_count != 0:
            raise AssertionError(f"{label}: {s.node_str()} did not run on the card "
                                 f"(device_runs={s.tpu_count}, fallbacks={s.fallback_count})")
    return stages


def _timed_collect(ctx, sql: str):
    """(answer, wall with planning, the compiled plan)."""
    from ballista_tpu_torch.engine.cuda_engine import maybe_compile_tpu

    t0 = time.time()
    physical = maybe_compile_tpu(ctx.create_physical_plan(ctx.sql(sql).plan), ctx.config)
    tbl = ctx.execute_collect(physical)
    return tbl, time.time() - t0, physical


def cold_run(q: int, data_dir: str, extra: dict, overlap: bool, chunk_rows: int, dev) -> tuple:
    """One cold run of TPC-H q (every table filled and every build prepared
    anew) under one cold-path setting: (its answer, its record). The build
    threads' card scopes are counted: with overlap on, each build enters
    the card's scope on its own thread."""
    from ballista_tpu_torch.client.context import SessionContext
    from ballista_tpu_torch.config import BallistaConfig
    from ballista_tpu_torch.ops.cuda import cuda_kernels as ck
    from ballista_tpu_torch.ops.cuda import stage_compiler as sc
    from ballista_tpu_torch.testing.tpchgen import register_tpch

    _fresh_card()
    ctx = SessionContext(BallistaConfig({
        **QUERY_CONFIG, **extra, "ballista.tpu.compile.overlap": overlap,
        "ballista.tpu.fill.chunk_rows": chunk_rows}))
    register_tpch(ctx, data_dir)
    scopes = []
    real_on_card = sc._on_card

    def on_card(card):
        scopes.append(str(card))
        return real_on_card(card)

    sc._on_card = on_card
    ck.reset_launches()
    try:
        tbl, wall, physical = _timed_collect(ctx, _query_sql(q))
    finally:
        sc._on_card = real_on_card
    launches = dict(ck.LAUNCHES)
    stages = [s for s in _device_stages(physical, f"cold q{q}")
              if isinstance(s, sc.TpuStageExec)]
    recs = [sc.RUN_STATS.stages().get(_tag(s), {}) for s in stages]
    n_builds = sum(len(r.get("build_modes") or ()) for r in recs)
    if overlap and (len(scopes) != n_builds or set(scopes) != {str(dev)}):
        raise AssertionError(f"cold q{q}: {n_builds} builds, card scopes {scopes}")
    if not overlap and scopes:
        raise AssertionError(f"cold q{q}: overlap off, yet builds ran on threads {scopes}")
    if launches["hash_probe"] < 1:
        raise AssertionError(f"cold q{q}: hash_probe launched {launches['hash_probe']} times")

    def total(key):
        return sum(float(r.get(key) or 0.0) for r in recs)

    return tbl, {
        "query": f"cold_q{q}", "overlap": overlap, "chunk_rows": chunk_rows,
        "cold_wall_s": wall, "fill_s": total("fill_s"), "upload_s": total("upload_s"),
        "encode_s": total("encode_s"), "build_s": total("build_s"), "builds": n_builds,
        "build_threads_on_card": len(scopes),
        "stages": [{k: r.get(k) for k in ("fill_s", "upload_s", "build_s", "build_modes",
                                          "device_bytes")} for r in recs],
        "hash_probe_launches": launches["hash_probe"], "launches": launches,
    }


@contextlib.contextmanager
def _s3_served(root: str):
    """The port's in-process S3 shim over `root` (each directory a bucket),
    with the environment its S3FileSystem reads, and a count of the HEAD
    requests it answers; everything put back after."""
    from ballista_tpu_torch.testing import mini_s3

    heads = []
    real_head = mini_s3._Handler.do_HEAD

    def counted(self):
        heads.append(self.path)
        return real_head(self)

    mini_s3._Handler.do_HEAD = counted
    srv, endpoint = mini_s3.start_mini_s3(root)
    env = {"AWS_ENDPOINT_URL": endpoint, "AWS_ACCESS_KEY_ID": "smoke",
           "AWS_SECRET_ACCESS_KEY": "smoke", "AWS_ALLOW_HTTP": "true",
           "AWS_REGION": "us-east-1"}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield heads
    finally:
        srv.shutdown()
        srv.server_close()
        mini_s3._Handler.do_HEAD = real_head
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _s3_session(bucket: str, extra: dict):
    from ballista_tpu_torch.client.context import SessionContext
    from ballista_tpu_torch.config import BallistaConfig

    ctx = SessionContext(BallistaConfig({**QUERY_CONFIG, **extra}))
    for t in S3_TABLES:
        ctx.register_parquet(t, f"s3://{bucket}/{t}")
    return ctx


def s3_query(q: int, bucket: str, extra: dict, kernel: str, heads: list, local: tuple,
             warm: int) -> dict:
    """q over s3:// orders and lineitem: cold after _fresh_card, then
    `warm` warm runs, each answer equal to the local-file run's answer and
    to engine=cpu's, every device stage on the card with no fallback, and
    `kernel` launched in every run; the HEAD requests of each run, those
    of its planning (each file's footer) and of its execution (each
    device stage's stamps, and a cold run's reads) apart."""
    from ballista_tpu_torch.engine.cuda_engine import maybe_compile_tpu
    from ballista_tpu_torch.ops.cuda import cuda_kernels as ck

    local_tbl, cpu_tbl = local
    _fresh_card()
    ctx = _s3_session(bucket, extra)
    ck.reset_launches()
    walls, per_run, plan_heads, exec_heads = [], [], [], []
    for i in range(1 + warm):
        before = dict(ck.LAUNCHES)
        n0 = len(heads)
        t0 = time.time()
        physical = maybe_compile_tpu(ctx.create_physical_plan(ctx.sql(_query_sql(q)).plan),
                                     ctx.config)
        n1 = len(heads)
        tbl = ctx.execute_collect(physical)
        wall = time.time() - t0
        plan_heads.append(n1 - n0)
        exec_heads.append(len(heads) - n1)
        per_run.append({k: ck.LAUNCHES[k] - before[k] for k in before})
        _device_stages(physical, f"s3 q{q}")
        if not tbl.equals(local_tbl):
            raise AssertionError(f"s3 q{q}: run {i} differs from the local-file run")
        compare_answers(tbl, cpu_tbl, f"s3 q{q}")
        if per_run[-1][kernel] < 1:
            raise AssertionError(f"s3 q{q}: run {i} launched {kernel} no time")
        walls.append(wall)
    return {"query": f"s3_q{q}", "cold_wall_s": walls[0], "times_s": walls[1:],
            "wall_s": min(walls[1:]) if warm else None, "plan_heads_per_run": plan_heads,
            "exec_heads_per_run": exec_heads,
            "files": len(ctx.catalog.get("orders").files) + len(ctx.catalog.get("lineitem").files),
            "kernel_launches_per_run": per_run, "launches": dict(ck.LAUNCHES)}


C26_SQL = "SELECT k, sum(v) AS s FROM t GROUP BY k ORDER BY k"


def c26_check(root: str) -> dict:
    """ROADMAP C26 on the card: one object, k = i mod 4 and v = i over 1000
    rows, then rewritten with v = 3i (the shim reports one mtime for every
    object, so the size changes) and registered again in a fresh session:
    the device stage answers the new sums."""
    import numpy as np
    import pyarrow as pa
    import pyarrow.parquet as pq

    from ballista_tpu_torch.client.context import SessionContext
    from ballista_tpu_torch.config import BallistaConfig

    path = os.path.join(root, "c26", "t", "part-0.parquet")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    i = np.arange(1000, dtype=np.int64)
    sums = []
    for factor in (1, 3):
        pq.write_table(pa.table({"k": i % 4, "v": i * factor}), path)
        ctx = SessionContext(BallistaConfig(dict(QUERY_CONFIG)))
        ctx.register_parquet("t", "s3://c26/t")
        tbl, _wall, physical = _timed_collect(ctx, C26_SQL)
        _device_stages(physical, "c26")
        sums.append(tbl.column("s").to_pylist())
    if sums != [[124500, 124750, 125000, 125250], [373500, 374250, 375000, 375750]]:
        raise AssertionError(f"c26: sums before and after the rewrite {sums}")
    return {"query": "c26_rewrite", "sums": sums}


def udf_check(bucket: str, data_dir: str) -> dict:
    """One UDF query over s3:// lineitem: its device stage declines with
    the reason it records, and the answer equals engine=cpu's over the
    local files."""
    import pyarrow as pa

    from ballista_tpu_torch.client.context import SessionContext
    from ballista_tpu_torch.config import BallistaConfig
    from ballista_tpu_torch.ops.cuda.stage_compiler import TpuStageExec
    from ballista_tpu_torch.testing import udf_fixtures

    ctx = _s3_session(bucket, {})
    ctx.register_udf("double_it", udf_fixtures.double_it, pa.int64())
    tbl, wall, physical = _timed_collect(ctx, UDF_SQL)
    stages = [n for n in _walk(physical) if isinstance(n, TpuStageExec)]
    if not stages or any(s.tpu_count or not s.fallback_count for s in stages):
        raise AssertionError(f"udf: the stage holding double_it did not decline: "
                             f"{[s.node_str() for s in stages]}")
    reasons = sorted({s.decline_reason for s in stages})
    if reasons != ["scalar fn double_it"]:
        raise AssertionError(f"udf: decline reasons {reasons}")
    cpu = SessionContext(BallistaConfig({"ballista.executor.engine": "cpu"}))
    cpu.register_parquet("lineitem", os.path.join(data_dir, "lineitem"))
    cpu.register_udf("double_it", udf_fixtures.double_it, pa.int64())
    want = cpu.sql(UDF_SQL).collect()
    if not tbl.equals(want):
        raise AssertionError("udf: the declined stage's answer differs from engine=cpu's")
    return {"query": "s3_udf", "wall_s": wall, "decline_reasons": reasons,
            "fallbacks": sum(s.fallback_count for s in stages), "rows": tbl.num_rows}


def cold_path_phase(data_dir: str, dev, answers: dict, launches: dict, late: bool,
                    emit) -> None:
    """Phase 15: (a) cold q5 (auto mode) and q21 (fused_pallas) under each
    cold-path setting, every answer byte-identical across the settings and
    equal to engine=cpu's; (b) q4 and q12 over s3:// tables, C26's rewrite,
    one UDF query. Reached late: (a) overlap off and on only, (b) q4 alone.
    The launch counts are set to 0 just before each run and read just
    after it."""
    settings = COLD_SETTINGS[:2] if late else COLD_SETTINGS
    for q, extra in COLD_QUERIES:
        first = None
        for name, overlap, chunk_rows in settings:
            tbl, r = cold_run(q, data_dir, extra, overlap, chunk_rows, dev)
            launches[f"cold_q{q}_{name}"] = r.pop("launches")
            if first is None:
                compare_answers(tbl, answers[q][1], q)
                first = tbl
            elif not tbl.equals(first):
                raise AssertionError(f"cold q{q}: the {name} answer differs from "
                                     f"the {settings[0][0]} one")
            emit(r)
            log(f"cold q{q} {name}: {r['cold_wall_s']:.3f} s, fill {r['fill_s']:.3f}, "
                f"upload {r['upload_s']:.3f}, build {r['build_s']:.3f} ({r['builds']} "
                f"builds), hash_probe {r['hash_probe_launches']}")
    root, bucket = os.path.dirname(os.path.abspath(data_dir)), os.path.basename(data_dir)
    t_b = time.time()
    try:
        with _s3_served(root) as heads:
            for q, extra, kernel in S3_QUERIES[:1] if late else S3_QUERIES:
                r = s3_query(q, bucket, extra, kernel, heads, answers[q], 1 if late else 3)
                launches[f"s3_q{q}"] = r.pop("launches")
                emit(r)
                log(f"s3 q{q}: cold {r['cold_wall_s']:.3f} s, warm {r['times_s']}, "
                    f"HEAD requests a run: planning {r['plan_heads_per_run']}, execution "
                    f"{r['exec_heads_per_run']}, over {r['files']} files")
            r = c26_check(root)
            emit(r)
            log(f"c26 on the card: sums {r['sums']}")
            if not late:
                r = udf_check(bucket, data_dir)
                emit(r)
                log(f"udf: declined ({r['decline_reasons']}), {r['wall_s']:.3f} s")
    finally:
        import shutil

        shutil.rmtree(os.path.join(root, "c26"), ignore_errors=True)
    emit({"query": "s3_phase", "wall_s": time.time() - t_b, "late": late})


# ---------------------------------------------------------------- TPC-H 22

# phase 16 (a): the TPC-H queries no earlier phase runs, local at --q4-scale
# in auto mode (each (query, mode name, config)), then q14 and q19 under
# fused_pallas, where their LIKE and IN predicates go through dict_filter
TPCH22_LOCAL = (2, 7, 8, 11, 14, 15, 16, 17, 18, 19, 20, 22)
TPCH22_FORMS = ([(q, "auto", {}) for q in TPCH22_LOCAL]
                + [(q, "fused_pallas", {"ballista.tpu.fusion.mode": "fused_pallas"})
                   for q in (14, 19)])


@contextlib.contextmanager
def _host_joins(spans: dict):
    """Record, by join mode, the [start, end] of every HashJoinExec partition
    the CPU engine runs (a device stage runs its joins itself)."""
    from ballista_tpu_torch.plan.physical import HashJoinExec

    execute = HashJoinExec.execute

    def timed(self, partition, ctx):
        def run():
            t0 = time.time()
            try:
                yield from execute(self, partition, ctx)
            finally:
                spans.setdefault(self.mode, []).append((t0, time.time()))
        return run()

    HashJoinExec.execute = timed
    try:
        yield
    finally:
        HashJoinExec.execute = execute


def _union_s(spans: list) -> float:
    """Seconds covered by the union of [start, end] spans."""
    total, reach = 0.0, float("-inf")
    for start, end in sorted(spans):
        if end > reach:
            total += end - max(start, reach)
            reach = end
    return total


def run_tpch22_query(q: int, name: str, extra: dict, data_dir: str, busy_ok: bool,
                     warm: int) -> tuple:
    """Phase 16 (a), one query: a cold run after every cache is dropped,
    best of `warm` and one traced run, each held to engine=cpu and to the
    port's CPU form (its claims and decline reasons); a fused_pallas sort
    stage launching its kernel. Returns (record, the last answer)."""
    from ballista_tpu_torch.client.context import SessionContext
    from ballista_tpu_torch.config import BallistaConfig
    from ballista_tpu_torch.engine.cuda_engine import maybe_compile_tpu
    from ballista_tpu_torch.ops.cuda import cuda_kernels as ck
    from ballista_tpu_torch.ops.cuda.stage_compiler import RUN_STATS
    from ballista_tpu_torch.testing.tpchgen import register_tpch

    label = f"q{q}" + ("" if name == "auto" else f" {name}")
    cpu_tbl, cpu_s, cpu_form = ORACLE.keyed(("tpch_form", q, name, data_dir))
    if cpu_form["error"] is not None:
        raise AssertionError(f"{label}: the CPU form raised {cpu_form['error']}")
    sql = _query_sql(q)
    ctx = SessionContext(BallistaConfig({**QUERY_CONFIG, **extra}))
    register_tpch(ctx, data_dir)
    _fresh_card()
    runs = []

    def one_run():
        before = dict(ck.LAUNCHES)
        spans: dict = {}
        t0 = time.time()
        with _host_joins(spans):
            physical = maybe_compile_tpu(ctx.create_physical_plan(ctx.sql(sql).plan),
                                         ctx.config)
            plan_s = time.time() - t0
            tbl = ctx.execute_collect(physical)
        wall = time.time() - t0
        launches = {k: ck.LAUNCHES[k] - before[k] for k in SIX_KERNELS}
        compare_answers(tbl, cpu_tbl, q,
                        F32_LANE_RTOL if launches["masked_group_reduce"] else 1e-9)
        claims = device_claims(physical)
        declines = _decline_reasons(physical)
        if _claimed(claims) != _claimed(cpu_form["claims"]):
            raise AssertionError(f"{label}: device claims {claims} on the card, "
                                 f"{cpu_form['claims']} on the CPU form")
        if sorted(set(declines)) != sorted(set(cpu_form["declines"])):
            raise AssertionError(f"{label}: declined for {declines} on the card, "
                                 f"{cpu_form['declines']} on the CPU form")
        if not claims:
            raise AssertionError(f"{label}: no device node was planned")
        sorts = _sort_decisions(physical)
        _check_sort_launches(label, sorts, launches)
        recs = RUN_STATS.stages()
        partial = [{k: recs.get(_tag(n), {}).get(k) for k in
                    ("fusion_mode", "fusion_reason", "hbm_plan", "n_seg", "build_modes",
                     "device_bytes")}
                   for n in _walk(physical) if type(n).__name__ == "TpuStageExec"]
        runs.append({"tbl": tbl, "wall": wall, "plan_s": plan_s, "launches": launches,
                     "claims": claims, "declines": declines, "sorts": sorts,
                     "partial": partial,
                     "host_join_s": {m: _union_s(v) for m, v in sorted(spans.items())},
                     "host_join_tasks": {m: len(v) for m, v in sorted(spans.items())}})

    for _ in range(1 + warm):  # cold, then best of `warm`
        one_run()
    best = min(range(1, 1 + warm), key=lambda k: runs[k]["wall"])
    t0 = time.time()
    by_name: dict = {}
    busy = device_busy_ms(one_run, by_name=by_name) if busy_ok else None
    traced_wall = time.time() - t0
    top_ops = sorted(([n[:80], ms, c] for n, (ms, c) in by_name.items()),
                     key=lambda r: -r[1])[:6]
    # a warm run reads every column of its stages' cached tables at least
    # once: a busy time below that byte floor means dropped events
    busy_floor_ms = (sum(p["device_bytes"] or 0 for p in runs[0]["partial"])
                     / HBM_BYTES_PER_S * 1e3)
    if busy is not None and busy < busy_floor_ms:
        log(f"{label}: profiler busy {busy:.4f} ms is below the tables' byte floor "
            f"{busy_floor_ms:.4f} ms: reported as null")
        busy = None
    r = runs[best]
    stages = [(p["fusion_mode"], p["fusion_reason"]) for p in r["partial"]]
    log(f"{label}: cold {runs[0]['wall']:.3f} s, warm {r['wall']:.4f} s (plan "
        f"{r['plan_s']:.4f}); stages {stages}; "
        f"sorts {[(s['fusion_modes'], s['fusion_reasons']) for s in r['sorts']]}; "
        f"launches {[{k: v for k, v in x['launches'].items() if v} for x in runs]}; "
        f"declines {r['declines']}; host joins {r['host_join_s']}; busy {busy} ms")
    rec = {
        "query": f"tpch22_q{q}" + ("" if name == "auto" else f"_{name}"), "mode": name,
        "config": extra, "cold_wall_s": runs[0]["wall"], "wall_s": r["wall"],
        "times_s": [x["wall"] for x in runs[1:1 + warm]], "plan_s": r["plan_s"],
        "cold_plan_s": runs[0]["plan_s"], "rows_out": cpu_tbl.num_rows, "cpu_engine_s": cpu_s,
        "device_nodes": _node_summary(r["claims"]), "declines": r["declines"],
        "partial_stages": r["partial"], "sort_stages": r["sorts"],
        "kernel_launches_per_run": [x["launches"] for x in runs],
        "host_join_s": r["host_join_s"], "host_join_tasks": r["host_join_tasks"],
        "traced_wall_s": traced_wall, "device_busy_ms": busy, "top_device_ops": top_ops,
        "busy_floor_ms": busy_floor_ms,
        "device_idle_share": None if busy is None else 1.0 - busy / 1e3 / traced_wall,
    }
    return rec, r["tbl"]


def tpch22_phase(data_dir: str, dev, busy_ok: bool, late: bool, launches: dict,
                 emit) -> None:
    """Phase 16: (a) TPCH22_FORMS local (run_tpch22_query; reached late,
    one warm run and no traced run), (b) (a)'s twelve in auto mode through
    the remote mode, each held to (a)'s answer (with all 22 remote the
    phase overran the 120 s it may take, PERF.md §4). The launch counts
    are set to 0 just before each query's runs and read just after them."""
    from ballista_tpu_torch.ops.cuda import cuda_kernels as ck

    t_a = time.time()
    local = {}
    for q, name, extra in TPCH22_FORMS:
        ck.reset_launches()
        r, tbl = run_tpch22_query(q, name, extra, data_dir, busy_ok, 1 if late else 3)
        r["launches"] = launches[r["query"]] = dict(ck.LAUNCHES)
        r["dict_filter_launches"] = _filter_launches()
        if r["dict_filter_launches"]:
            log(f"q{q} {name}: dict_filter by (P, N, T, regime, masked) "
                f"{r['dict_filter_launches']}")
        emit(r)
        if name == "auto":
            local[q] = (r, tbl)
    emit({"query": "tpch22_local", "wall_s": time.time() - t_a, "late": late})
    t_b = time.time()
    cluster = start_remote_cluster()
    try:
        for q in TPCH22_LOCAL:
            local_rec, local_tbl = local[q]
            mgr = any(x["masked_group_reduce"] for x in local_rec["kernel_launches_per_run"])
            ck.reset_launches()
            r = run_remote_query(q, data_dir, {}, None, dev, False, local_rec, local_tbl,
                                 cluster, force_remote=True, warm_runs=1,
                                 rtol=F32_LANE_RTOL if mgr else 1e-9)
            r["query"] = f"tpch22_remote_q{q}"
            r["launches"] = launches[r["query"]] = dict(ck.LAUNCHES)
            emit(r)
            log(f"remote q{q}: warm-up {r['cold_wall_s']:.3f} s, {r['wall_s']:.3f} s, "
                f"{r['stages']} stages, tasks {r['tasks_per_stage']}, device passes "
                f"{r['device_passes_per_stage']}, launches "
                f"{ {k: v for k, v in r['launches'].items() if v} }")
    finally:
        stop_remote_cluster(cluster[0], cluster[2])
    emit({"query": "tpch22_remote", "wall_s": time.time() - t_b})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scale", type=float, default=10.0)
    ap.add_argument("--q4-scale", type=float, default=1.0)
    ap.add_argument("--data-dir", default=os.path.join(ROOT, "build", "tpch"))
    ap.add_argument("--tpcds-dir", default=os.path.join(ROOT, "build", "tpcds"))
    ap.add_argument("--daemon-client", metavar="SPEC",
                    help="run as a client process of phase 11 (internal)")
    args = ap.parse_args(argv)
    if args.daemon_client:
        return daemon_client_main(args.daemon_client)

    import torch

    if not torch.cuda.is_available():
        log("no CUDA device: this script runs the port on the card only")
        return 2
    sys.path.insert(0, ROOT)
    try:
        from ballista_tpu_torch.ops.cuda import build, cuda_kernels
    except ImportError as e:
        log(f"the port is not importable ({e}): run from the root of a checkout")
        return 2

    card = card_line()
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    scale_s = f"{args.scale:g}"
    big_dir = os.path.join(args.data_dir, f"sf{scale_s}")
    q4_dir = os.path.join(args.data_dir, f"sf{args.q4_scale:g}")
    ds_small_dir = os.path.join(args.tpcds_dir, f"sf{TPCDS_SMALL_SCALE:g}")
    ds_big_dir = os.path.join(args.tpcds_dir, f"sf{TPCDS_BIG_SCALE:g}")
    procs = []
    try:
        t0 = time.time()
        big = start_generate(big_dir, args.scale)
        procs.append(big)
        small = (start_generate(q4_dir, args.q4_scale)
                 if q4_dir != big_dir else None)
        procs.append(small)
        ds_small = start_generate(ds_small_dir, TPCDS_SMALL_SCALE, "tpcds")
        ds_big = start_generate(ds_big_dir, TPCDS_BIG_SCALE, "tpcds")
        procs += [ds_small, ds_big]
        delta_dirs = [os.path.join(args.data_dir, f"delta{seed}") for seed in SERVING_DELTA_SEEDS]
        deltas = [start_generate(d, SERVING_DELTA_SCALE, f"delta{seed}")
                  for d, seed in zip(delta_dirs, SERVING_DELTA_SEEDS)]
        procs += deltas

        tb = time.time()
        build.build_all()
        build_s = time.time() - tb
        for name, text in build.LOGS.items():
            for line in text.splitlines():
                log(f"nvcc {name}: {line}")
        log(f"kernels built in {build_s:.1f}s")

        busy_ok = check_busy_method(dev)
        krecs = ([kernel_phase(dev, busy_ok)] + gather_phase(dev, busy_ok)
                 + sort_family_phase(dev, busy_ok))
        log(f"kernel phase done at {time.time() - t0:.1f}s")

        # the engine=cpu answers of phases 4-14 while --scale's data is
        # generated: TPC-DS at TPCDS_SMALL_SCALE (with the CPU form's
        # claims) first, then the --q4-scale data's and TPC-DS (b)'s,
        # heaviest first
        wait_generate(ds_small, ds_small_dir, TPCDS_SMALL_SCALE, "tpcds")
        ORACLE.submit_tpcds(range(1, 100), ds_small_dir)
        wait_generate(small if q4_dir != big_dir else big, q4_dir, args.q4_scale)
        ORACLE.submit([(_query_sql(q), q4_dir) for q, (which, _) in SORTED_QUERIES.items()
                       if which == "small"] + [(_query_sql(q), q4_dir) for q in (5, 12, 1, 4)])
        submit_mesh_oracle(q4_dir)
        ORACLE.submit_tpch_forms(TPCH22_FORMS, q4_dir)  # phase 16 (a)'s
        wait_generate(ds_big, ds_big_dir, TPCDS_BIG_SCALE, "tpcds")
        ORACLE.submit_tpcds(TPCDS_BIG_QUERIES, ds_big_dir)
        # phase 12's answers last in this pool: --scale's go to the next
        for proc, d, seed in zip(deltas, delta_dirs, SERVING_DELTA_SEEDS):
            wait_generate(proc, d, SERVING_DELTA_SCALE, f"delta{seed}")
        submit_serving_oracle(q4_dir, delta_dirs)
        log(f"TPC-DS ready at {time.time() - t0:.1f}s")
        # phase 10 (a) on the card meanwhile, each query once as its
        # answer comes in; the launch counts are set to 0 just before each
        # query and read just after it
        launches = {}
        t10 = time.time()
        launches["tpcds_small"] = tpcds_small_phase(ds_small_dir, card)
        _fresh_card()
        log(f"TPC-DS (a) took {time.time() - t10:.1f}s, done at {time.time() - t0:.1f}s")
        wait_generate(big, big_dir, args.scale)
        log(f"data ready at {time.time() - t0:.1f}s")
        ORACLE.widen()
        ORACLE.submit([(_query_sql(q), big_dir) for q in (5, 3, 12, 1, 6)]
                      + [(sql, big_dir) for sql, _ in SORT_QUERIES.values()])
        q21_ref = q21_large_reference(big_dir)
        log(f"q21 large's fused_xla reference done at {time.time() - t0:.1f}s")
        ORACLE.wait()
        log(f"engine=cpu answers ready at {time.time() - t0:.1f}s")

        # the main paths: the counts are set to 0 just before each query
        # and read just after it
        recs, answers = {}, {}  # phase 7 reads phases 4 and 6

        def emit(r: dict, scale: float) -> None:
            r["scale"] = scale
            r["card"] = card
            print(json.dumps(r), flush=True)

        def path_query(q: int, path_dir: str, scale: float) -> None:
            cuda_kernels.reset_launches()
            r = recs[q] = run_query(q, path_dir, dev, busy_ok, answers)
            r["launches"] = launches[q] = dict(cuda_kernels.LAUNCHES)
            r["hash_probe_launches"] = _probe_launches()
            r["dict_filter_launches"] = _filter_launches()
            emit(r, scale)
            log(f"q{q} done at {time.time() - t0:.1f}s; segmented_sort launches per run "
                f"{[run['segmented_sort'] for run in r['kernel_launches_per_run']]}"
                + (f"; dict_filter by (P, N, T, regime, masked) {r['dict_filter_launches']}"
                   if r["dict_filter_launches"] else ""))

        def sorted_query(q: int, path_dir: str, scale: float, extra: dict) -> None:
            cuda_kernels.reset_launches()
            r = recs[q] = run_sorted_query(q, path_dir, dev, busy_ok, extra, answers)
            r["launches"] = launches[q] = dict(cuda_kernels.LAUNCHES)
            r["hash_probe_launches"] = _probe_launches()
            emit(r, scale)
            log(f"q{q} (sorted) done at {time.time() - t0:.1f}s")

        for q, path_dir, scale in ((1, big_dir, args.scale), (6, big_dir, args.scale),
                                   (5, big_dir, args.scale), (12, big_dir, args.scale),
                                   (4, q4_dir, args.q4_scale)):
            path_query(q, path_dir, scale)
        # the sort family, same data; counts set to 0 just before each run
        for name in SORT_QUERIES:
            cuda_kernels.reset_launches()
            r = run_sort_query(name, big_dir, dev, busy_ok)
            # every run's launches, the traced run's included
            r["launches"] = launches[name] = {
                k: sum(run[k] for run in r["kernel_launches_per_run"]) + r["traced_launches"][k]
                for k in cuda_kernels.LAUNCHES}
            emit(r, args.scale)
            log(f"{name} done at {time.time() - t0:.1f}s")
        # the sorted aggregation, then the staged mode and device routing
        for q, (which, extra) in SORTED_QUERIES.items():
            path_dir, scale = ((big_dir, args.scale) if which == "big"
                               else (q4_dir, args.q4_scale))
            sorted_query(q, path_dir, scale, extra)
        for check in (staged_check, routing_check):
            r = check(q4_dir)
            emit(r, args.q4_scale)
            log(f"{r['query']} done at {time.time() - t0:.1f}s")
        # q21 at --scale: its supplier table (2^17 entries at SF10) through
        # hash_probe's shared-memory regimes; the counts are set to 0 inside,
        # just before its fused_pallas runs, and read just after them. One
        # warm run: each is host-bound (its builds over 60M lineitem rows,
        # about 22 s), and the run's time limit needs the room phase 11 takes
        # reached late, it drops its traced run (about 30 s on a slow host)
        r = q21_large_check(big_dir, args.scale, dev,
                            busy_ok and warm_runs(t0, "q21_large") > 1, q21_ref, warm=1)
        launches["q21_large"] = r["launches"]
        # its builds now run beside the fill (ballista.tpu.compile.overlap
        # on by default): their wall against the serial order's 22.2 s
        r["build_s_cold"] = sum(st.get("build_s") or 0.0 for st in r["cold_stages"])
        r["build_s_warm"] = sum(st.get("build_s") or 0.0 for st in r["stages"])
        log(f"q21 large build_s cold {r['build_s_cold']:.3f} s, warm "
            f"{r['build_s_warm']:.3f} s (overlap on; the serial order's, PERF.md: 22.2 s)")
        emit(r, args.scale)
        log(f"q21 at SF{scale_s} done at {time.time() - t0:.1f}s")
        # q1, q5 and q12 at --q4-scale, local on the card as in phase 4: the
        # records and answers that phase 7's grace split of q5 and phases 8
        # and 9 (a) hold their runs at that scale to (q4's are phase 4's)
        small_recs, small_answers = {4: recs[4]}, {4: answers[4]}
        for q in (1, 5, 12):
            cuda_kernels.reset_launches()
            r = small_recs[q] = run_query(q, q4_dir, dev, busy_ok, small_answers)
            r["launches"] = launches[f"q{q}_small"] = dict(cuda_kernels.LAUNCHES)
            r["dict_filter_launches"] = _filter_launches()
            if r["dict_filter_launches"]:
                log(f"q{q} at SF{args.q4_scale:g}: dict_filter by (P, N, T, regime, masked) "
                    f"{r['dict_filter_launches']}")
            emit(r, args.q4_scale)
        # out of core: the launch counts of the grace q5 runs are set to 0
        # just before each run and read just after it
        t7 = time.time()
        for r in out_of_core_phase(big_dir, q4_dir, dev, busy_ok, recs, answers,
                                   small_recs, small_answers):
            if r["query"] == "q5_grace":
                launches["q5_grace"] = r["launches"]
            r["scale"] = args.q4_scale if r["query"] in (
                "q5_grace", "q5_grace_depth2", "spill_touch_disk") else args.scale
            r["card"] = card
            print(json.dumps(r), flush=True)
        log(f"out-of-core phase took {time.time() - t7:.1f}s, done at {time.time() - t0:.1f}s")
        # the standalone mode: the launch counts are set to 0 just before
        # each query's runs and read just after them
        t8 = time.time()
        for q, which, extra, kernel in STANDALONE_QUERIES:
            path_dir, scale, local_recs, local_answers = (
                (big_dir, args.scale, recs, answers) if which == "big"
                else (q4_dir, args.q4_scale, small_recs, small_answers))
            cuda_kernels.reset_launches()
            r = run_standalone_query(q, path_dir, extra, dev, busy_ok, local_recs[q],
                                     local_answers[q][0], kernel=kernel)
            r["launches"] = launches[f"standalone_q{q}"] = dict(cuda_kernels.LAUNCHES)
            emit(r, scale)
            log(f"standalone q{q} done at {time.time() - t0:.1f}s")
        # q3 once more over two executors, every shuffle read over Flight
        cuda_kernels.reset_launches()
        r = run_standalone_query(3, big_dir, {}, dev, busy_ok, recs[3], answers[3][0],
                                 num_executors=2, force_remote=True, warm_runs=0)
        r["launches"] = launches["standalone_q3_flight"] = dict(cuda_kernels.LAUNCHES)
        emit(r, args.scale)
        log(f"standalone phase took {time.time() - t8:.1f}s, done at {time.time() - t0:.1f}s")
        # the remote mode: (a) in-process daemons over real sockets, the
        # launch counts set to 0 just before each query's runs and read just
        # after them; (b) a pull executor beside the push one, q3 over Flight
        t9 = time.time()
        _fresh_card()  # the cold runs fill their tables as phase 8's did
        cluster = start_remote_cluster()
        try:
            for q, which, extra, kernel in REMOTE_QUERIES:
                path_dir, scale, local_recs, local_answers = (
                    (big_dir, args.scale, recs, answers) if which == "big"
                    else (q4_dir, args.q4_scale, small_recs, small_answers))
                warm = warm_runs(t0, "remote") if q in REMOTE_SLOW else 3
                cuda_kernels.reset_launches()
                r = run_remote_query(q, path_dir, extra, kernel, dev, busy_ok, local_recs[q],
                                     local_answers[q][0], cluster, warm_runs=warm)
                r["warm_runs"] = warm
                r["launches"] = launches[f"remote_q{q}"] = dict(cuda_kernels.LAUNCHES)
                emit(r, scale)
                log(f"remote q{q} done at {time.time() - t0:.1f}s")
        finally:
            stop_remote_cluster(cluster[0], cluster[2])
        cluster = start_remote_cluster(pull=True)
        try:
            cuda_kernels.reset_launches()
            r = run_remote_query(3, big_dir, {}, None, dev, busy_ok, recs[3], answers[3][0],
                                 cluster, force_remote=True, warm_runs=0)
            r["launches"] = launches["remote_q3_flight"] = dict(cuda_kernels.LAUNCHES)
            emit(r, args.scale)
        finally:
            stop_remote_cluster(cluster[0], cluster[2])
        log(f"remote q3 over Flight done at {time.time() - t0:.1f}s")
        # (c) real scheduler and executor daemons; this process's tables
        # and builds are dropped first (the daemon holds its own context)
        _fresh_card()
        r = remote_daemons_check(big_dir, q4_dir, answers)
        r["card"] = card
        print(json.dumps(r), flush=True)
        log(f"remote phase took {time.time() - t9:.1f}s, done at {time.time() - t0:.1f}s")
        # the warm device daemon on the card: its launches are the deltas of
        # its own counts across each client's runs (read from its status)
        t11 = time.time()
        _fresh_card()  # the daemon sizes its budget from the whole card
        r = daemon_phase(q4_dir, {q: small_answers[q][0] for q in (1, 4, 5, 12)})
        for q, counts in r["launches"].items():
            launches[f"daemon_{q}"] = counts
        r["scale"], r["card"] = args.q4_scale, card
        print(json.dumps(r), flush=True)
        log(f"daemon phase took {time.time() - t11:.1f}s, done at {time.time() - t0:.1f}s")
        # TPC-DS (b): the sort and window shapes and q93 at
        # TPCDS_BIG_SCALE; the launch counts are set to 0 just before each
        # query and read just after it
        t10 = time.time()
        _fresh_card()
        for q in TPCDS_BIG_QUERIES:
            cuda_kernels.reset_launches()
            r = run_tpcds_big_query(q, ds_big_dir, dev, busy_ok, warm_runs(t0, "tpcds_big"))
            r["launches"] = launches[f"tpcds_big_q{q}"] = dict(cuda_kernels.LAUNCHES)
            r["scale"], r["card"] = TPCDS_BIG_SCALE, card
            print(json.dumps(r), flush=True)
            log(f"TPC-DS q{q} at scale {TPCDS_BIG_SCALE:g} done at {time.time() - t0:.1f}s")
        log(f"TPC-DS (b) took {time.time() - t10:.1f}s, done at {time.time() - t0:.1f}s")
        # the serving surface: prepared statements, continuous queries,
        # direct dispatch, the remote mode; the launch counts are set to 0
        # just before each part and read just after it
        t12 = time.time()
        _fresh_card()
        # reached late, it keeps every check and drops its traced runs
        serving_phase(q4_dir, delta_dirs, busy_ok and warm_runs(t0, "serving") > 1,
                      launches, lambda r: emit(r, args.q4_scale))
        log(f"serving phase took {time.time() - t12:.1f}s, done at {time.time() - t0:.1f}s")
        # the SQL CLI: the launch counts are set to 0 just before (a)'s
        # process and read just after it
        t13 = time.time()
        _fresh_card()
        for r in cli_phase(q4_dir, {q: small_answers[q][0] for q in (4, 5, 12)}, launches):
            emit(r, args.q4_scale)
        log(f"cli phase took {time.time() - t13:.1f}s, done at {time.time() - t0:.1f}s")
        # the mesh: the launch counts are set to 0 just before each query
        # of (c) and read just after it
        t14 = time.time()
        _fresh_card()
        mesh_phase(q4_dir, dev, launches, lambda r: emit(r, args.q4_scale))
        log(f"mesh phase took {time.time() - t14:.1f}s, done at {time.time() - t0:.1f}s")
        # the cold path and the object store: the launch counts are set to
        # 0 just before each run and read just after it
        t15 = time.time()
        late = time.time() - t0 > LATE_AT["cold_path"]
        if late:
            log(f"cold_path reached past {LATE_AT['cold_path']:g}s: its late form "
                "(overlap off and on, q4 alone over S3)")
        cold_answers = {5: small_answers[5], 21: answers[21], 4: answers[4],
                        12: small_answers[12]}
        cold_path_phase(q4_dir, dev, cold_answers, launches, late,
                        lambda r: emit(r, args.q4_scale))
        log(f"cold path phase took {time.time() - t15:.1f}s, done at {time.time() - t0:.1f}s")
        # TPC-H 22: the launch counts are set to 0 just before each query's
        # runs and read just after them
        t16 = time.time()
        late = time.time() - t0 > LATE_AT["tpch22"]
        if late:
            log(f"tpch22 reached past {LATE_AT['tpch22']:g}s: its late form (one warm "
                "run, no traced run)")
        tpch22_phase(q4_dir, dev, busy_ok and not late, late, launches,
                     lambda r: emit(r, args.q4_scale))
        log(f"tpch22 phase took {time.time() - t16:.1f}s, done at {time.time() - t0:.1f}s")
        path_of = {"masked_group_reduce": (4,),
                   "hash_probe": (5, 21, "q21_large", "q5_grace", "q5_small"),
                   "dict_filter": (12, "q12_small"),
                   "segmented_sort": ("win_orders", "sort_customer"),
                   "topk_select": ("topk_partsupp",), "segmented_scan": ("win_orders",)}
        standalone = [k for k in launches if str(k).startswith("standalone_")]
        remote = [k for k in launches if str(k).startswith("remote_")]
        tpcds = [k for k in launches if str(k).startswith("tpcds_")]
        daemon = [k for k in launches if str(k).startswith("daemon_")]
        serving = [k for k in launches if str(k).startswith("serving_")]
        mesh = [k for k in launches if str(k).startswith("mesh_")]
        cold = [k for k in launches if str(k).startswith(("cold_", "s3_"))]
        tpch22 = [k for k in launches if str(k).startswith("tpch22_")]
        for krec in krecs:
            krec["standalone_launches"] = sum(launches[q][krec["name"]] for q in standalone)
            krec["remote_launches"] = sum(launches[q][krec["name"]] for q in remote)
            krec["tpcds_launches"] = sum(launches[q].get(krec["name"], 0) for q in tpcds)
            krec["daemon_launches"] = sum(launches[q].get(krec["name"], 0) for q in daemon)
            krec["serving_launches"] = sum(launches[q].get(krec["name"], 0) for q in serving)
            krec["cli_launches"] = launches["cli_remote"].get(krec["name"], 0)
            krec["mesh_launches"] = sum(launches[q].get(krec["name"], 0) for q in mesh)
            krec["cold_path_launches"] = sum(launches[q].get(krec["name"], 0) for q in cold)
            krec["tpch22_launches"] = sum(launches[q].get(krec["name"], 0) for q in tpch22)
            krec["launches"] = (sum(launches[q][krec["name"]] for q in path_of[krec["name"]])
                                + krec["standalone_launches"] + krec["remote_launches"]
                                + krec["tpcds_launches"] + krec["daemon_launches"]
                                + krec["serving_launches"] + krec["cli_launches"]
                                + krec["mesh_launches"] + krec["cold_path_launches"]
                                + krec["tpch22_launches"])
            if krec["launches"] < 1:
                raise AssertionError(f"the main path launched {krec['name']} no time")
        log(f"path phase done at {time.time() - t0:.1f}s")
    except Exception:  # noqa: BLE001 — every phase failure is fatal
        traceback.print_exc()
        return 1
    finally:
        ORACLE.stop()
        for p in procs:
            if p is not None and p.poll() is None:
                p.kill()
                p.wait()

    print(json.dumps({"kernels": krecs}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
