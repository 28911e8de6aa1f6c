"""One-card smoke test of the aligner's main path on an NVIDIA GPU.

    python chip_smoke.py [--seed S] [--ref-len BASES]

Phases, all in this one process (it is the only one that opens the card):

1. device:   the default JAX device must be a GPU; prints its kind, the
             device count, the card's name and power limit, and whether
             the native host runtime loaded (it must).
2. dp:       1024 bench-shape DP jobs (256-1024 columns, 1-4 rows per
             side, radius 30) plus tall (K/L up to 8) and wide (radius
             140) jobs, all on the device with the host lane and host
             route off, through the CUDA kernel and through the plain XLA
             core; every result bit-equal to yama_numpy. Prints the
             compiled memory analysis of the largest bucket and warm
             timings of both cores.
3. goldens:  the GPU-marked tests (multiz v=1/v=0 and tba goldens, byte
             equal to the reference outputs) via pytest.main.
4. tba:      a 5-species tba (BASELINE.json config 3's shape) over
             --ref-len bases of simulated reference, through
             cli.tba.main: inline, auto, auto with the host lane off, and
             the plain core with the host lane off. Every run must be
             byte-equal to the inline run; auto must select the device
             executor, and with the host lane off the device must take
             the DP jobs. Prints each run's device/host/fallback split.

The last line is {"ok": true, "device": {...}}; any failure raises and
exits non-zero before it is printed.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SPECIES = ("chimp", "mouse", "rat", "dog")
DIVERGENCE = (0.02, 0.25, 0.30, 0.33)
TREE = "((((human chimp) mouse) rat) dog)"


def log(msg: str) -> None:
    print(msg, flush=True)


def phase_device(card: dict) -> None:
    import jax

    from multiz_jax import yama as Y

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"no GPU: the default JAX device is {dev.platform}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    card.update(platform=dev.platform, kind=dev.device_kind,
                count=len(jax.devices()), smi=smi)
    log(f"[device] platform={dev.platform} kind={dev.device_kind} "
        f"count={len(jax.devices())}")
    log(f"[device] nvidia-smi: {smi}")
    log(f"[device] native host runtime loaded: {Y._mzcore is not None}")
    if Y._mzcore is None:
        raise SystemExit("native host runtime (_mzcore) did not load")


def _dp_jobs(seed: int):
    from multiz_jax.ops.synth import synth_jobs

    return (
        synth_jobs(1024, m_lo=256, m_hi=1024, k_lo=1, k_hi=4, radius=30,
                   seed=seed)
        + synth_jobs(32, m_lo=150, m_hi=400, k_lo=4, k_hi=8, radius=12,
                     seed=seed + 1)
        + synth_jobs(32, m_lo=300, m_hi=340, radius=140, seed=seed + 2)
    )


def _device_launches(jobs, core):
    """Packed launches of a one-shot stream, ready for _device_batch."""
    import jax.numpy as jnp

    from multiz_jax.ops import yama_pack as YP

    st = YP.PackedDPStream(core=core, host_threads=0, host_route=0,
                           autoflush=False)
    for j in jobs:
        st.submit(j)
    out = []
    for key, slots in st.buckets.items():
        nb = YP._launch_size(len(slots))
        m_pad, n_pad, Kp, Lp, wcap = key
        kw = dict(go=st.go, ge=st.ge, m_pad=m_pad, n_pad=n_pad, Kp=Kp,
                  Lp=Lp, B=nb, wcap=wcap, core=core)
        out.append((jnp.asarray(st._pack(slots, nb, key)), st.ss_cat, kw,
                    len(slots)))
    return out


def _time_core(jobs, want, cells, core, card) -> dict:
    """Check one DP core against yama_numpy, then time it warm: end to
    end, device programs (prep + core), and the core alone."""
    import jax

    from multiz_jax.ops import yama_pack as YP

    def run():
        return YP.yama_batch_packed(jobs, core=core, host_threads=0,
                                    host_route=0)

    t0 = time.perf_counter()
    YP.reset_route_counts()
    got = run()
    first = time.perf_counter() - t0
    counts = YP.route_counts()
    bad = [i for i, (g, w) in enumerate(zip(got, want))
           if g.shape != w.shape or not (g == w).all()]
    if bad or counts["device_jobs"] != len(jobs):
        raise SystemExit(f"[dp] core {core}: {len(bad)} results differ "
                         f"from yama_numpy (first {bad[:5]}); {counts}")

    def best(fn):
        fn()
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            fn()
            times.append(time.perf_counter() - t0)
        return min(times)

    e2e = best(run)
    launches = _device_launches(jobs, core)
    dev = best(lambda: jax.block_until_ready(
        [YP._device_batch(buf, ss, **kw) for buf, ss, kw, _ in launches]))
    # the core alone, on operands prepped once
    core_fn = jax.jit(YP._run_core, static_argnames=(
        "go", "ge", "m_pad", "n_pad", "wcap", "core"))
    prepped = []
    for buf, ss, kw, _ in launches:
        parts = YP._unpack_wire(buf, kw["B"], kw["m_pad"], kw["n_pad"],
                                kw["Kp"], kw["Lp"])
        cstat, rstat = jax.jit(YP._prep_batch)(*parts, ss)
        ckw = {k: kw[k] for k in ("go", "ge", "m_pad", "n_pad", "wcap",
                                  "core")}
        prepped.append((cstat, rstat, parts[4], ckw))
    alone = best(lambda: jax.block_until_ready(
        [core_fn(c, r, m, **k) for c, r, m, k in prepped]))
    log(f"[dp] core={core}: {len(jobs)} jobs bit-equal to yama_numpy; "
        f"first call {first:.3f}s (compile incl.), warm end-to-end "
        f"{e2e:.4f}s ({cells / e2e:.0f} cells/s), device programs "
        f"(prep + core) {dev:.4f}s, core alone {alone:.4f}s, "
        f"{counts['launches']} launches [{card['smi']}]")
    if core == "cuda":
        buf, ss, kw, n = max(
            launches,
            key=lambda L: L[3] * YP._job_bytes(
                L[2]["m_pad"], L[2]["n_pad"], L[2]["Kp"], L[2]["Lp"],
                L[2]["wcap"], core),
        )
        mem = YP._device_batch.lower(buf, ss, **kw).compile()
        log(f"[dp] largest bucket {n} jobs {kw}: {mem.memory_analysis()}")
    return dict(first_s=first, e2e_s=e2e, device_s=dev, core_s=alone)


def phase_dp(seed: int, card: dict) -> dict:
    from multiz_jax.ops.synth import band_cells
    from multiz_jax.yama import yama_numpy

    jobs = _dp_jobs(seed)
    cells = band_cells(jobs)
    want = [yama_numpy(*j) for j in jobs]
    log(f"[dp] {len(jobs)} jobs, {cells} band cells")
    res = {core: _time_core(jobs, want, cells, core, card)
           for core in ("cuda", "xla")}
    ratio = {k: res["xla"][k] / res["cuda"][k]
             for k in ("e2e_s", "device_s", "core_s")}
    log(f"[dp] plain core / kernel: end-to-end {ratio['e2e_s']:.2f}x, "
        f"device programs {ratio['device_s']:.2f}x, core alone "
        f"{ratio['core_s']:.2f}x")
    return res


def phase_goldens() -> None:
    import pytest

    class Outcomes:
        def __init__(self):
            self.passed, self.other = 0, []

        def pytest_runtest_logreport(self, report):
            if report.when == "call" and report.passed:
                self.passed += 1
            elif report.failed or report.skipped:
                self.other.append((report.nodeid, report.outcome))

    os.environ["MULTIZ_TEST_DEVICE"] = "gpu"
    oc = Outcomes()
    rc = pytest.main(
        ["-q", "-p", "no:cacheprovider", "-m", "gpu",
         os.path.join(ROOT, "tests", "test_gpu_golden.py")],
        plugins=[oc],
    )
    log(f"[goldens] pytest rc={int(rc)} passed={oc.passed} other={oc.other}")
    if rc != 0 or oc.other or oc.passed == 0:
        raise SystemExit("[goldens] GPU golden tests did not all pass")


def _simulate(d: str, seed: int, ref_len: int) -> None:
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from sim import SimConfig, simulate

    from multiz_jax.cli import single_cov2

    simulate(SimConfig(seed=seed, ref_len=ref_len, species=SPECIES,
                       divergence=DIVERGENCE), d)
    for s in SPECIES:
        with open(os.path.join(d, f"human.{s}.sing.maf"), "w") as fh:
            single_cov2.main([os.path.join(d, f"human.{s}.orig.maf")],
                             out=fh)


def _tba(d: str, env: dict) -> tuple:
    from multiz_jax.cli import tba
    from multiz_jax.ops import yama_pack as YP

    keys = ("MULTIZ_DEVICE", "MZ_HOST_DP_THREADS", "MZ_HOST_ROUTE_CELLS")
    saved = {k: os.environ.pop(k, None) for k in keys}
    os.environ.update(env)
    cwd = os.getcwd()
    os.chdir(d)
    try:
        YP.reset_route_counts()
        t0 = time.perf_counter()
        tba.main([TREE] + [f"human.{s}.sing.maf" for s in SPECIES]
                 + ["out.maf"])
        dt = time.perf_counter() - t0
        with open("out.maf", "rb") as fh:
            data = fh.read()
        os.remove("out.maf")
    finally:
        os.chdir(cwd)
        for k in keys:
            os.environ.pop(k, None)
            if saved[k] is not None:
                os.environ[k] = saved[k]
    return data, dt, YP.route_counts()


def phase_tba(seed: int, ref_len: int, card: dict) -> dict:
    from multiz_jax.ops import dispatch

    device_only = {"MZ_HOST_DP_THREADS": "0", "MZ_HOST_ROUTE_CELLS": "0"}
    runs = (
        ("inline", {"MULTIZ_DEVICE": "none"}),
        ("auto", {}),
        ("auto-device-only", device_only),
        ("plain-device-only", {"MULTIZ_DEVICE": "jax", **device_only}),
    )
    if dispatch.default_batch_fn() is None:
        raise SystemExit("[tba] auto dispatch does not select the device")
    res = {}
    scratch = os.path.join(ROOT, ".cache")
    os.makedirs(scratch, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=scratch) as d:
        t0 = time.perf_counter()
        _simulate(d, seed, ref_len)
        log(f"[tba] simulated {ref_len} bases x {len(SPECIES) + 1} species "
            f"+ single_cov2 in {time.perf_counter() - t0:.1f}s")
        base = None
        for name, env in runs:
            times = []
            for _ in range(1 if name == "inline" else 2):
                data, dt, counts = _tba(d, env)
                times.append(dt)
                if base is None:
                    base = data
                elif data != base:
                    raise SystemExit(f"[tba] {name}: output differs from "
                                     "the inline run")
            res[name] = dict(seconds=times, counts=counts)
            log(f"[tba] {name}: {len(base)} bytes, byte-equal to inline; "
                f"runs {['%.3f' % t for t in times]}s; routes {counts} "
                f"[{card['smi']}]")
            # with the host lane on, the size router may keep every job
            # on the host; with it off the device must carry the DP
            if name.endswith("device-only") and counts["device_jobs"] == 0:
                raise SystemExit(f"[tba] {name}: the device took no DP jobs")
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--ref-len", type=int, default=1_000_000)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import multiz_jax  # noqa: F401  (sets the compile cache before jax)

    card: dict = {}
    t0 = time.perf_counter()
    phase_device(card)
    phase_dp(args.seed, card)
    phase_goldens()
    phase_tba(args.seed, args.ref_len, card)
    log(f"[done] all phases passed in {time.perf_counter() - t0:.1f}s")
    print(json.dumps({"ok": True, "device": {
        "platform": card["platform"], "kind": card["kind"],
        "count": card["count"]}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
