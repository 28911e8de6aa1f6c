"""The CUDA kernel's own source (ops/cuda/yama_dp.cuh) on the CPU.

tests/tools/yama_dp_emu.cpp compiles the kernel body with g++ and runs
each problem's warp as 32 threads whose shuffles go through a barrier.
Its payload (op count + packed edit script) must equal the plain XLA
core's, byte for byte, and replay to the oracle's merged alignment
(mz_yama.c:138-154 tie-breaking included). The same operands feed the
kernel on the card (tests/test_gpu_golden.py, chip_smoke.py).
"""

import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest

from multiz_jax import scores as sc
from multiz_jax import yama as Y
from multiz_jax.ops import yama_pack as YP
from multiz_jax.ops.synth import diag_band, synth_block, synth_jobs

from .conftest import GOLDEN

HERE = os.path.dirname(os.path.abspath(__file__))
CUDA_DIR = os.path.join(os.path.dirname(HERE), "multiz_jax", "ops", "cuda")


@pytest.fixture(scope="module")
def emu(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ not found")
    so = str(tmp_path_factory.mktemp("emu") / "libyamaemu.so")
    subprocess.run(
        [gxx, "-O1", "-std=c++20", "-shared", "-fPIC", "-pthread",
         "-I", CUDA_DIR, "-o", so,
         os.path.join(HERE, "tools", "yama_dp_emu.cpp")],
        check=True, capture_output=True,
    )
    return ctypes.CDLL(so)


def _buckets(jobs):
    """Launch operands per bucket, exactly as PackedDPStream builds them:
    [(slots, key, cstat, rstat, mnkl)]."""
    import jax.numpy as jnp

    st = YP.PackedDPStream(core="xla", host_threads=0, host_route=0,
                           autoflush=False)
    for j in jobs:
        st.submit(j)
    assert not st.results, "a job fell back to the host"
    ss = jnp.asarray(sc.current.ss_cat)
    out = []
    for key, slots in st.buckets.items():
        m_pad, n_pad, Kp, Lp, _ = key
        nb = YP._launch_size(len(slots))
        parts = YP._unpack_wire(
            jnp.asarray(st._pack(slots, nb, key)), nb, m_pad, n_pad, Kp, Lp
        )
        cstat, rstat = YP._prep_batch(*parts, ss)
        out.append((slots, key, cstat, rstat, parts[4]))
    return out


def _check(emu, jobs):
    sp = sc.current
    go, ge = int(sp.gap_open), int(sp.gap_extend)
    for slots, key, cstat, rstat, mnkl in _buckets(jobs):
        m_pad, n_pad, _, _, wcap = key
        want = np.asarray(YP._xla_core(cstat, rstat, mnkl, go=go, ge=ge,
                                       m_pad=m_pad, n_pad=n_pad))
        cs, rs, mk = (np.ascontiguousarray(np.asarray(x), np.int32)
                      for x in (cstat, rstat, mnkl))
        nb = cs.shape[0]
        outw = YP._out_width(m_pad, n_pad)
        got = np.zeros((nb, outw), np.uint8)
        flags = np.zeros((nb, m_pad + 1, wcap), np.uint8)
        ptr = [a.ctypes.data_as(ctypes.c_void_p)
               for a in (cs, rs, mk, got, flags)]
        emu.mz_yama_dp_emu(*ptr, nb, m_pad + 1, n_pad + 1, outw, wcap,
                           go, ge)
        for i, slot in enumerate(slots):
            ne = int(want[i, :4].view("<u4")[0])
            assert got[i, :4].view("<u4")[0] == ne, f"job {slot}"
            nbytes = (ne + 3) // 4
            np.testing.assert_array_equal(
                got[i, 4 : 4 + nbytes], want[i, 4 : 4 + nbytes],
                err_msg=f"job {slot}",
            )
        assert (got[len(slots) :, :4] == 0).all()  # padding slots
        results = {}
        YP._replay_payload(got, slots, dict(enumerate(jobs)), results)
        for slot in slots:
            np.testing.assert_array_equal(
                results[slot], Y.yama_numpy(*jobs[slot]),
                err_msg=f"job {slot}",
            )


def _full_band(rng, M, N, K=1, L=1):
    return (synth_block(rng, M, K), synth_block(rng, N, L),
            np.zeros(M + 1, np.int64), np.full(M + 1, N, np.int64))


def _workload(name):
    rng = np.random.default_rng(3)
    if name == "radius30":  # the production radius: two segments a row
        return synth_jobs(6, m_lo=30, m_hi=120, k_lo=1, k_hi=4,
                          radius=30, seed=11)
    if name == "narrow":  # one segment; the band moves every row
        jobs = []
        for _ in range(4):
            M, N = (int(x) for x in rng.integers(100, 150, size=2))
            jobs.append((synth_block(rng, M, 2), synth_block(rng, N, 3),
                         *diag_band(M, N, 8)))
        return jobs
    if name == "wide":  # row 0 and every row span ten segments
        return [_full_band(rng, 12, 300), _full_band(rng, 5, 40, 3, 2)]
    if name == "tall":  # K/L up to 8 rows
        return synth_jobs(4, m_lo=60, m_hi=120, k_lo=4, k_hi=8,
                          radius=12, seed=6)
    if name == "steep":  # M << N: the band jumps many columns per row
        jobs = []
        for M, N in ((20, 200), (40, 150)):
            jobs.append((synth_block(rng, M, 2), synth_block(rng, N, 2),
                         *diag_band(M, N, 6)))
        return jobs
    raise KeyError(name)


@pytest.mark.parametrize("name", ["radius30", "narrow", "wide", "tall",
                                  "steep"])
def test_kernel_emulation_bit_equal(emu, name):
    _check(emu, _workload(name))


@pytest.mark.parametrize("part", range(4))
def test_kernel_emulation_reference_fixtures(emu, part):
    """The reference-C fixture cases (tests/golden/yama_fuzz.npz, 64
    problems with the C binary's outputs), a quarter per test."""
    data = np.load(os.path.join(GOLDEN, "yama_fuzz.npz"))
    n = int(data["n_cases"])
    jobs = [
        tuple(data[f"case{i}_{k}"] for k in ("A", "B", "LB", "RB"))
        for i in range(part, n, 4)
    ]
    jobs = [j for j in jobs if YP.pick_wcap(j[2], j[3], j[0].shape[0])]
    assert jobs
    _check(emu, jobs)
