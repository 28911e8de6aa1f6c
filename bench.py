"""Headline benchmark: batched banded yama DP throughput on one GPU.

Prints the device (platform, device kind, count) and the card's name and
power limit, then ONE JSON line: {"metric", "value", "unit", "device"}.
Fails when the default JAX device is not a GPU.

Workload: 1024 synthetic banded align-two-alignments problems (columns
256..1024, rows 1..4 per side, radius-30 diagonal band — the multiz
defaults, multi_util.c:13). Timing covers the FULL framework path: host
packing of texts, on-device column statistics, the band-local CUDA DP +
in-kernel traceback (multiz_jax/ops/yama_pack.py, ops/cuda/yama_dp.cu),
and host replay into merged column matrices. Every result is
bit-identical to the reference DP.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

N_PROBLEMS = int(os.environ.get("MZ_BENCH_N", "1024"))
SEED = 42
ITERS = 5


def main() -> None:
    import multiz_jax  # noqa: F401  (sets the compile cache before jax)
    import jax

    from multiz_jax.ops.synth import band_cells, synth_jobs
    from multiz_jax.ops.yama_pack import yama_batch_packed

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"no GPU: the default JAX device is {dev.platform}")
    device = {"platform": dev.platform, "kind": dev.device_kind,
              "count": len(jax.devices())}
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(f"# device {device}; nvidia-smi: {smi}", flush=True)

    jobs = synth_jobs(
        N_PROBLEMS, m_lo=256, m_hi=1024, k_lo=1, k_hi=4, radius=30,
        seed=SEED,
    )
    cells = band_cells(jobs)
    yama_batch_packed(jobs)  # warmup: compile every bucket shape
    best = 0.0
    for _ in range(ITERS):
        t0 = time.perf_counter()
        out = yama_batch_packed(jobs)
        dt = time.perf_counter() - t0
        assert len(out) == len(jobs)
        best = max(best, cells / dt)
    print(
        json.dumps(
            {
                "metric": "yama_dp_cells_per_sec",
                "value": best,
                "unit": f"band-cells/s ({N_PROBLEMS}-problem batch, "
                        f"end-to-end, best of {ITERS})",
                "device": device,
            }
        ),
        flush=True,
    )


if __name__ == "__main__":
    main()
