"""Where `hash_probe`'s split regime gives way to its cluster regime.

    python -m ballista_tpu_torch.testing.hash_probe_crossover

Past S entries (one block's opt-in shared memory) the split regime holds
the table's first S entries in every block and reads the rest through L2;
the cluster regime holds 2 S in a pair of CTAs, half of it read from the
peer. `cuda_kernels.hash_probe_regime` switches from one to the other at
T = HP_SPLIT_MAX_QUARTERS / 4 S. This script times both, and the L2
(global) regime, at the same tables, from 2 S + 1 up to the engine's cap of
2^18 entries, at [8, 2^23] rows (keys uniform in [0, T), 70% of slots
present, 90% of the mask set). It drives the kernel's C launcher
directly with each regime; each launch is first held exactly against
`hash_probe_plain`. CUDA-event ms per call over 50 calls, three rounds
with the regimes alternating. Prints the card's name and power limit, then
one JSON line. Needs a CUDA card; exits non-zero without one.
"""

from __future__ import annotations

import json
import subprocess
import sys

REGIMES = ("split", "cluster", "global")


def main() -> int:
    import numpy as np
    import torch

    from ballista_tpu_torch.ops.cuda import cuda_kernels as ck

    if not torch.cuda.is_available():
        print("hash_probe_crossover: needs a CUDA card", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip(),
          flush=True)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    optin = ck.hash_probe_smem_optin(dev)
    s = ck.hash_probe_block_max(optin)
    cut = s * ck.HP_SPLIT_MAX_QUARTERS // 4
    launch = ck._hp_lib()[0]
    rng = np.random.default_rng(3)
    P, n = 8, 1 << 23
    sizes = sorted({2 * s + 1, 120000, 125000, cut, cut + 1, 1 << 17, 135000, 140000, 150000,
                    165000, 180000, 200000, 230000, 1 << 18})
    out = {"optin": optin, "S": s, "split_max": cut, "shape": [P, n], "ms": {}}
    for T in sizes:
        table_np = np.full(T, -1, np.int32)
        slots = rng.choice(T, size=int(T * 0.7), replace=False)
        table_np[slots] = rng.permutation(len(slots)).astype(np.int32)
        table = torch.as_tensor(table_np, device=dev)
        keys = torch.as_tensor(rng.integers(0, T, (P, n), dtype=np.int32), device=dev)
        mask = torch.as_tensor(rng.random((P, n), dtype=np.float32) < 0.9, device=dev)
        rows = torch.empty_like(keys)
        matched = torch.empty(keys.shape, dtype=torch.bool, device=dev)
        want = ck.hash_probe_plain(keys, table, mask)

        def run(regime):
            rc = launch(keys.data_ptr(), mask.data_ptr(), table.data_ptr(), T, rows.data_ptr(),
                        matched.data_ptr(), keys.numel(), ck._HP_REGIMES.index(regime), optin,
                        ck._hp_cap(dev, T, regime, optin), torch.cuda.current_stream().cuda_stream)
            if rc != 0:
                raise RuntimeError(f"hash_probe T={T} {regime}: CUDA error {rc}")

        for regime in REGIMES:
            run(regime)
            if not (torch.equal(rows, want[0]) and torch.equal(matched, want[1])):
                raise AssertionError(f"hash_probe T={T} {regime}: differs from the plain form")
        times = {r: [] for r in REGIMES}
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        for _ in range(3):
            for regime in REGIMES:
                for _ in range(5):
                    run(regime)
                start.record()
                for _ in range(50):
                    run(regime)
                end.record()
                torch.cuda.synchronize()
                times[regime].append(start.elapsed_time(end) / 50)
        out["ms"][T] = {**times, "chosen": ck.hash_probe_regime(T, optin)[0]}
        del keys, mask, rows, matched, want
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
