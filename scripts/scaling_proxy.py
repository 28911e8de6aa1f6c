"""Multi-process scaling-efficiency proxy on the CPU backend (BASELINE
gate: >=80% at 2 hosts).

Measures the scaling of the production device-DP path
(``distributed_yama_batch_packed`` — the same shard_map + all-gather
program a multi-device run uses, with the plain XLA core since the CPU
backend has no CUDA kernel) over jax.distributed PROCESSES, with each
process pinned to its own physical core via taskset — process p on core
p models host p: separate runtime, separate compute resource, real
cross-process collectives through the distributed runtime. CPU times
only: no statement about any accelerator.

Fixed GLOBAL workload; T(n) = best wall time of the collective batch
call over ITERS runs (post-compile); efficiency = T(1) / (n * T(n)).
Measured at 96 jobs (narrow — the r3 gate miss) and 256 jobs.

Run: python scripts/scaling_proxy.py   (prints one JSON line per width)
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)

WORKER = r"""
import os, sys, time
sys.path.insert(0, os.environ["MZ_REPO"])
import numpy as np
import jax

nproc = int(os.environ["MZ_NPROC"])
if nproc > 1:
    jax.distributed.initialize(
        coordinator_address=os.environ["MZ_COORD"],
        num_processes=nproc,
        process_id=int(os.environ["MZ_PID"]),
    )

from multiz_jax.ops.synth import synth_jobs
from multiz_jax.parallel.distributed import distributed_yama_batch_packed

# fixed global workload regardless of process count (identical list on
# every process; the pipeline plans deterministically the same way)
njobs = int(os.environ.get("MZ_PROXY_JOBS", "96"))
jobs = synth_jobs(njobs, m_lo=192, m_hi=255, k_lo=1, k_hi=3, radius=30,
                  seed=11)

distributed_yama_batch_packed(jobs, core="xla")  # compile + warm
iters = int(os.environ.get("MZ_ITERS", "3"))
best = 1e9
for _ in range(iters):
    t0 = time.perf_counter()
    distributed_yama_batch_packed(jobs, core="xla")
    best = min(best, time.perf_counter() - t0)
if int(os.environ["MZ_PID"]) == 0:
    print(f"RESULT {best:.4f}", flush=True)
"""


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    p = s.getsockname()[1]
    s.close()
    return p


def run_config(nproc: int, njobs: int) -> float:
    port = _free_port()
    procs = []
    for pid in range(nproc):
        env = dict(
            os.environ,
            MZ_REPO=REPO,
            MZ_COORD=f"127.0.0.1:{port}",
            MZ_NPROC=str(nproc),
            MZ_PID=str(pid),
            MZ_PROXY_JOBS=str(njobs),
            MZ_HOST_ROUTE_CELLS="0",
            JAX_PLATFORMS="cpu",
            XLA_FLAGS="--xla_force_host_platform_device_count=1",
        )
        procs.append(
            subprocess.Popen(
                ["taskset", "-c", str(pid), sys.executable, "-c", WORKER],
                env=env, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True,
            )
        )
    t = None
    for p in procs:
        out, _ = p.communicate(timeout=1800)
        if p.returncode != 0:
            raise RuntimeError(out[-2000:])
        for line in out.splitlines():
            if line.startswith("RESULT "):
                t = float(line.split()[1])
    assert t is not None
    return t


def main():
    widths = [int(w) for w in sys.argv[1:]] or [96, 256]
    for njobs in widths:
        t1 = run_config(1, njobs)
        t2 = run_config(2, njobs)
        eff = t1 / (2 * t2)
        print(json.dumps({
            "metric": "scaling_efficiency_2proc_cpu_proxy_packed",
            "jobs": njobs,
            "t1_sec": round(t1, 4),
            "t2_sec": round(t2, 4),
            "value": round(eff, 3),
            "gate": 0.80,
        }), flush=True)


if __name__ == "__main__":
    main()
