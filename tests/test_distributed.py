"""Multi-host entry: real multi-process jax.distributed over the CPU
backend (2 processes x 4 virtual devices = 8-device global mesh), with
per-host job feeding and bit-equality against the host oracle.

This replaces the reference's process model (/tmp files + system(),
speciesTree.c:16-35) with one SPMD program spanning processes.
"""

import os
import socket
import subprocess
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)

WORKER = r"""
import os, sys
sys.path.insert(0, os.environ["MZ_REPO"])
import numpy as np
import jax

jax.distributed.initialize(
    coordinator_address=os.environ["MZ_COORD"],
    num_processes=int(os.environ["MZ_NPROC"]),
    process_id=int(os.environ["MZ_PID"]),
)
assert jax.process_count() == int(os.environ["MZ_NPROC"])
assert jax.device_count() == 8, jax.devices()

from multiz_jax.ops.synth import synth_jobs
from multiz_jax.parallel.distributed import (
    distributed_yama_batch, local_shard,
)
from multiz_jax.yama import yama_numpy

# deterministic GLOBAL list; same on every process
jobs = synth_jobs(16, m_lo=24, m_hi=31, k_lo=1, k_hi=3, radius=8, seed=5)
lo, hi = local_shard(len(jobs))
local = jobs[lo:hi]
outs = distributed_yama_batch(local)
bad = 0
for j, got in zip(local, outs):
    want = yama_numpy(*j)
    if got.shape != want.shape or not np.array_equal(got, want):
        bad += 1
print(f"proc {jax.process_index()}: shard [{lo},{hi}) bad={bad}",
      flush=True)
sys.exit(1 if bad else 0)
"""


WORKER_PACKED = r"""
import os, sys
sys.path.insert(0, os.environ["MZ_REPO"])
import numpy as np
import jax

jax.distributed.initialize(
    coordinator_address=os.environ["MZ_COORD"],
    num_processes=int(os.environ["MZ_NPROC"]),
    process_id=int(os.environ["MZ_PID"]),
)
from multiz_jax.ops.synth import synth_jobs
from multiz_jax.parallel.distributed import distributed_yama_batch_packed
from multiz_jax.yama import yama_numpy

# GLOBAL job list, identical on every process; results are
# all-gathered so EVERY process checks the full list. CPU backend: the
# plain XLA core stands in for the CUDA kernel (same operands, same
# payload, same shard_map program around it).
jobs = synth_jobs(18, m_lo=16, m_hi=28, k_lo=1, k_hi=2, radius=8, seed=7)
outs = distributed_yama_batch_packed(jobs, core="xla")
bad = 0
for j, got in zip(jobs, outs):
    want = yama_numpy(*j)
    if got.shape != want.shape or not np.array_equal(got, want):
        bad += 1
print(f"proc {jax.process_index()}: packed global bad={bad}", flush=True)
sys.exit(1 if bad else 0)
"""


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    p = s.getsockname()[1]
    s.close()
    return p


def _run_workers(worker_src, nproc=2):
    port = _free_port()
    procs = []
    for pid in range(nproc):
        env = dict(
            os.environ,
            MZ_REPO=REPO,
            MZ_COORD=f"127.0.0.1:{port}",
            MZ_NPROC=str(nproc),
            MZ_PID=str(pid),
            JAX_PLATFORMS="cpu",
            XLA_FLAGS="--xla_force_host_platform_device_count=4",
            MULTIZ_NO_NATIVE=os.environ.get(
                "MULTIZ_NO_NATIVE", ""
            ),
        )
        procs.append(
            subprocess.Popen(
                [sys.executable, "-c", worker_src],
                env=env, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True,
            )
        )
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=560)
        outs.append(out)
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-2000:]
    return outs


def test_two_process_distributed_yama():
    outs = _run_workers(WORKER)
    assert any("shard [0," in o for o in outs), outs


def test_two_process_packed_global():
    """The production device DP shard_mapped over a 2-process mesh:
    global bucketing, all-gathered results, bit-equal on every rank."""
    outs = _run_workers(WORKER_PACKED)
    assert all("packed global bad=0" in o for o in outs), outs
