"""Device (jitted band-local) yama vs the NumPy oracle and golden C outputs."""

import os

import numpy as np
import pytest

from multiz_jax import yama as Y
from multiz_jax.ops.synth import synth_jobs
from multiz_jax.ops.yama_jax import yama_batch, yama_jax

from .conftest import GOLDEN

FIX = os.path.join(GOLDEN, "yama_fuzz.npz")


def test_yama_jax_matches_reference_fixtures():
    data = np.load(FIX)
    n = int(data["n_cases"])
    for i in range(n):
        A = data[f"case{i}_A"]
        B = data[f"case{i}_B"]
        LB = data[f"case{i}_LB"]
        RB = data[f"case{i}_RB"]
        want = data[f"case{i}_out"]
        got = yama_jax(A, B, LB, RB)
        assert np.array_equal(got, want), f"case {i} mismatch"


def test_yama_batch_matches_numpy_on_synth():
    jobs = synth_jobs(24, m_lo=16, m_hi=200, k_lo=1, k_hi=5, radius=12,
                      seed=11)
    got = yama_batch(jobs)
    for i, (A, B, LB, RB) in enumerate(jobs):
        want = Y.yama_numpy(A, B, LB, RB)
        assert np.array_equal(got[i], want), f"job {i} mismatch"


def test_yama_batch_sharded_matches_numpy():
    import jax

    from multiz_jax.parallel.sharding import make_mesh

    devices = jax.devices("cpu")
    if len(devices) < 2:
        pytest.skip("needs multi-device mesh")
    mesh = make_mesh(devices[: 4 if len(devices) >= 4 else 2],
                     band=2 if len(devices) >= 4 else 1)
    jobs = synth_jobs(10, m_lo=16, m_hi=64, radius=8, seed=5)
    got = yama_batch(jobs, mesh=mesh)
    for i, (A, B, LB, RB) in enumerate(jobs):
        want = Y.yama_numpy(A, B, LB, RB)
        assert np.array_equal(got[i], want), f"job {i} mismatch"
