"""CPU tests of the production device-DP executor (ops/yama_pack.py).

Runs the full path — host packing into the wire buffer, device-side prep
from packed texts, the DP core, the 2-bit script payload and host
replay — with the plain XLA core (``core="xla"``) standing in for the
CUDA kernel, asserting bit-equality against the host oracle (the
bit-exactness bar of the reference's tie-breaking, mz_yama.c:138-154).
The kernel itself runs on the CPU in tests/test_yama_kernel_emu.py and
on the card in tests/test_gpu_golden.py; both cores read the same
operands and write the same payload.
"""

import numpy as np
import pytest

from multiz_jax import yama as Y
from multiz_jax.ops import yama_pack as YP
from multiz_jax.ops.synth import diag_band, synth_block, synth_jobs


@pytest.fixture(autouse=True)
def _device_route(monkeypatch):
    # force every job through the device path (default routes tiny
    # buckets and small jobs to the native host DP)
    monkeypatch.setenv("MZ_HOST_ROUTE_CELLS", "0")
    monkeypatch.setenv("MZ_HOST_JOB_CELLS", "0")


def _run(jobs, **kw):
    return YP.yama_batch_packed(jobs, core="xla", **kw)


def _assert_jobs_equal(jobs, got):
    assert len(got) == len(jobs)
    for i, ((A, B, LB, RB), out) in enumerate(zip(jobs, got)):
        want = Y.yama_numpy(A, B, LB, RB)
        assert out.shape == want.shape, f"job {i}: shape {out.shape} != {want.shape}"
        np.testing.assert_array_equal(out, want, err_msg=f"job {i}")


def test_fuzz_bit_equal():
    """Mixed M/N/K/L at the production radius; 10 jobs over 2+ buckets,
    with zero padding slots (bucket sizes below the launch ladder)."""
    jobs = synth_jobs(
        10, m_lo=20, m_hi=120, k_lo=1, k_hi=4, radius=30, seed=11
    )
    _assert_jobs_equal(jobs, _run(jobs))


def test_narrow_band_chunks():
    """A radius-8 band moving across 150-column problems: each row's
    band starts at a different column, so the flag rows and the
    traceback's band offsets move every row."""
    rng = np.random.default_rng(5)
    jobs = []
    for _ in range(8):
        M = int(rng.integers(120, 160))
        N = int(rng.integers(120, 160))
        A = synth_block(rng, M, 2)
        B = synth_block(rng, N, 3)
        LB, RB = diag_band(M, N, 8)
        jobs.append((A, B, LB, RB))
    _assert_jobs_equal(jobs, _run(jobs))


def test_wide_band_window_ladder():
    """A band wider than the default 64-column flag row climbs the WCAPS
    ladder instead of falling back to the host, mixed into a batch that
    otherwise runs at 64; both buckets must stay bit-exact."""
    rng = np.random.default_rng(9)
    M, N = 12, 300
    A = synth_block(rng, M, 1)
    B = synth_block(rng, N, 1)
    LB = np.zeros(M + 1, dtype=np.int64)  # full band: 301 columns
    RB = np.full(M + 1, N, dtype=np.int64)
    assert YP.pick_wcap(LB, RB, M) == 1024
    wide = (A, B, LB, RB)
    jobs = [wide] + synth_jobs(4, m_lo=24, m_hi=48, radius=30, seed=21)
    assert YP.pick_wcap(jobs[1][2], jobs[1][3], jobs[1][0].shape[0]) == 64
    _assert_jobs_equal(jobs, _run(jobs))


def test_band_beyond_ladder_falls_back():
    """Bands wider than the widest rung (1024 columns) still fall back
    to the exact host oracle, and are counted as fallback."""
    rng = np.random.default_rng(14)
    M, N = 40, 1100
    A = synth_block(rng, M, 1)
    B = synth_block(rng, N, 1)
    LB = np.zeros(M + 1, dtype=np.int64)
    RB = np.full(M + 1, N, dtype=np.int64)
    assert YP.pick_wcap(LB, RB, M) is None
    jobs = [(A, B, LB, RB)]
    YP.reset_route_counts()
    _assert_jobs_equal(jobs, _run(jobs))
    c = YP.route_counts()
    assert c["fallback_jobs"] == 1 and c["device_jobs"] == 0


def test_wide_group_bit_equal():
    """25 jobs of one bucket run as one launch padded to 32 slots on the
    launch ladder; the 7 padding slots (M = 0) are skipped by the core
    and never replayed."""
    jobs = synth_jobs(25, m_lo=16, m_hi=48, k_lo=1, k_hi=3, radius=8,
                      seed=13)
    assert YP._launch_size(25) == 32
    YP.reset_route_counts()
    _assert_jobs_equal(jobs, _run(jobs))
    c = YP.route_counts()
    assert c["device_jobs"] == 25 and c["launches"] >= 1


def test_host_route_small_buckets(monkeypatch):
    """With the default routing threshold, tiny buckets bypass the device
    entirely and still produce oracle-identical results."""
    monkeypatch.setenv("MZ_HOST_ROUTE_CELLS", "1000000")
    jobs = synth_jobs(4, m_lo=16, m_hi=32, radius=30, seed=2)
    YP.reset_route_counts()
    _assert_jobs_equal(jobs, _run(jobs))
    c = YP.route_counts()
    assert c["device_jobs"] == 0 and c["host_jobs"] == 4


def test_launch_size_ladder():
    sizes = [YP._launch_size(n) for n in (1, 8, 9, 13, 17, 25, 33, 49, 65,
                                          97, 129)]
    assert sizes == [8, 8, 12, 16, 24, 32, 48, 64, 96, 128, 192]
    for n in range(9, 600):
        s = YP._launch_size(n)
        assert n <= s and 3 * (s - n) < s  # padding below a third


def test_launch_cap_from_device_memory(monkeypatch):
    """The per-launch job cap follows the device memory over the bytes a
    job holds, rounded down to the launch ladder; the plain core's
    full-row flags make its jobs costlier than the kernel's."""
    monkeypatch.setattr(YP, "_device_memory_bytes", lambda: 8 << 30)
    key = (1024, 1024, 8, 8, 64)
    cap_k = YP._launch_cap(*key, "cuda")
    cap_x = YP._launch_cap(*key, "xla")
    assert cap_k == YP._launch_size(cap_k)
    assert cap_k * YP._job_bytes(*key, "cuda") <= (8 << 30) // 4
    assert 8 <= cap_x < cap_k
    monkeypatch.setattr(YP, "_device_memory_bytes", lambda: 1 << 20)
    assert YP._launch_cap(*key, "cuda") == 8  # never below one rung


def test_launch_cap_splits_bucket(monkeypatch):
    """A bucket larger than the cap runs as several launches, all
    bit-exact."""
    monkeypatch.setattr(YP, "_launch_cap", lambda *a: 8)
    jobs = synth_jobs(19, m_lo=20, m_hi=30, radius=8, seed=3)
    YP.reset_route_counts()
    _assert_jobs_equal(jobs, _run(jobs))
    assert YP.route_counts()["launches"] == 3


def test_streaming_flush_bit_equal(monkeypatch):
    """Autoflush streaming (the merge scan's mode): mid-stream launches
    of ladder-sized chunks plus the tail in finish()."""
    monkeypatch.setattr(YP, "LAUNCH_CHUNK", 8)
    jobs = synth_jobs(21, m_lo=20, m_hi=40, radius=8, seed=17)
    st = YP.PackedDPStream(core="xla", host_threads=0)
    for j in jobs:
        st.submit(j)
    assert st.pending  # launched before finish()
    _assert_jobs_equal(jobs, st.finish())


def test_unknown_core_rejected():
    with pytest.raises(ValueError):
        YP.PackedDPStream(core="pallas")


def test_cuda_core_needs_gpu():
    """The kernel core never falls back to another executor: without a
    GPU (and its toolkit) the launch fails."""
    import jax

    if jax.devices()[0].platform == "gpu":
        pytest.skip("a GPU is present")
    jobs = synth_jobs(2, m_lo=20, m_hi=30, radius=8, seed=1)
    with pytest.raises(Exception):
        YP.yama_batch_packed(jobs, core="cuda")


def test_bad_payload_raises():
    """A walk that left the band comes back as op count 0xFFFFFFFF and
    is reported like the oracle's traceback error."""
    (A, B, LB, RB), = synth_jobs(1, m_lo=20, m_hi=30, radius=8, seed=4)
    out = np.zeros((1, 16), np.uint8)
    out[0, :4] = 0xFF
    with pytest.raises(Y.YamaError):
        YP._replay_payload(out, [0], [(A, B, LB, RB)], [None])


def test_prep_matches_column_stats():
    """Device prep from the wire buffer reproduces the oracle's column
    statistics, band bounds and substitution projection."""
    import jax.numpy as jnp

    from multiz_jax import scores as sc

    jobs = synth_jobs(3, m_lo=20, m_hi=28, k_lo=2, k_hi=6, radius=8,
                      seed=8)
    st = YP.PackedDPStream(core="xla", host_threads=0, autoflush=False)
    for j in jobs:
        st.submit(j)
    (key, slots), = st.buckets.items()
    m_pad, n_pad, Kp, Lp, _ = key
    buf = st._pack(slots, 8, key)
    parts = YP._unpack_wire(jnp.asarray(buf), 8, m_pad, n_pad, Kp, Lp)
    ss = jnp.asarray(sc.current.ss_cat)
    cstat, rstat = (np.asarray(x) for x in YP._prep_batch(*parts, ss))
    for i, slot in enumerate(slots):
        A, B, LB, RB = jobs[slot]
        M, N = A.shape[0], B.shape[0]
        sa, sb = Y.column_stats(A), Y.column_stats(B)
        np.testing.assert_array_equal(cstat[i, 0, : N + 1], sb.nond)
        np.testing.assert_array_equal(cstat[i, 1, : N + 1], sb.ndash)
        np.testing.assert_array_equal(cstat[i, 2:6, : N + 1], sb.pair.T)
        np.testing.assert_array_equal(
            cstat[i, 6:12, : N + 1], (sb.hist @ sc.current.ss_cat.T).T
        )
        np.testing.assert_array_equal(rstat[i, : M + 1, 0], sa.nond)
        np.testing.assert_array_equal(rstat[i, : M + 1, 2:6], sa.pair)
        np.testing.assert_array_equal(rstat[i, : M + 1, 6:12], sa.hist)
        np.testing.assert_array_equal(rstat[i, : M + 1, YP.RS_LB], LB)
        np.testing.assert_array_equal(rstat[i, : M + 1, YP.RS_RB], RB)
    assert (np.asarray(parts[4])[len(slots) :] == 0).all()  # padding


def test_native_band_info_matches_python():
    from multiz_jax.yama import _mzcore

    if _mzcore is None:
        pytest.skip("native runtime not built")
    rng = np.random.default_rng(2)
    for radius in (5, 30, 140, 600):
        M = int(rng.integers(20, 400))
        N = int(rng.integers(20, 1400))
        LB, RB = diag_band(M, N, radius)
        wcap, width, cells = _mzcore.band_info(
            np.ascontiguousarray(LB), np.ascontiguousarray(RB), M, N,
            np.asarray(YP.WCAPS, np.int64),
        )
        assert (wcap or None) == YP.pick_wcap(LB, RB, M)
        assert width == int((RB - LB).max())
        assert cells == int((np.minimum(RB, N) - LB).sum()) + M
