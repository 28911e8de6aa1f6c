"""GPU-gated end-to-end goldens: the production device DP (the CUDA
kernel through PackedDPStream) must reproduce the reference
byte-for-byte.

The default suite runs on the virtual CPU mesh (tests/conftest.py) and
never compiles the kernel; these tests close that gap. They are
deselected by default (pytest.ini: -m "not gpu") and run with
`MULTIZ_TEST_DEVICE=gpu pytest -m gpu` on a host with a GPU (chip_smoke.py
runs them). Reference behavior under test: multiz merge scan
(multiz.c:60-177) and the tba dataflow (tba.c:114-276) with every
overlap DP executed by yama_batch_packed on the card instead of the
host oracle.
"""

from __future__ import annotations

import io
import os

import pytest

from .conftest import GOLDEN

pytestmark = pytest.mark.gpu

DATA = os.path.join(GOLDEN, "data")
EXPECT = os.path.join(GOLDEN, "expect")


@pytest.fixture(autouse=True)
def _force_device(monkeypatch):
    """Force every DP bucket onto the kernel: the default host-route
    threshold (1M cells) would send these small golden workloads to the
    native host DP and the card would never be exercised, and the host
    DP lane would likewise absorb every small job."""
    monkeypatch.setenv("MZ_HOST_ROUTE_CELLS", "0")
    monkeypatch.setenv("MZ_HOST_JOB_CELLS", "0")


@pytest.fixture(scope="module")
def gpu_device():
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"no GPU: the default JAX device is {dev.platform}")
    return dev


def _expect(name: str) -> str:
    with open(os.path.join(EXPECT, name)) as fh:
        return fh.read()


def _block_lines(text: str):
    return [l for l in text.split("\n") if l and not l.startswith("#")]


@pytest.mark.parametrize("v", [1, 0])
def test_multiz_golden_packed_on_chip(gpu_device, v, monkeypatch):
    import jax

    from multiz_jax.cli import multiz as cli

    monkeypatch.setenv("MULTIZ_DEVICE", "packed")
    out = io.StringIO()
    with jax.default_device(gpu_device):
        cli.main(
            [os.path.join(DATA, "human.chimp.sing.maf"),
             os.path.join(DATA, "human.mouse.sing.maf"), str(v)],
            out=out,
        )
    got = "\n".join(
        l for l in out.getvalue().split("\n")
        if not l.startswith("# multiz.v")
    )
    want = "\n".join(
        l for l in _expect(f"multiz_v{v}.maf").split("\n")
        if not l.startswith("# multiz.v")
    )
    assert got == want  # byte-identical modulo the argv echo line


def test_tba_golden_packed_on_chip(gpu_device):
    import jax

    from multiz_jax import scores as sc
    from multiz_jax.maf import format_ali
    from multiz_jax.multiz import MultizConfig
    from multiz_jax.ops.yama_pack import yama_batch_packed
    from multiz_jax.tree import tba_run

    sp = sc.init_scores70()
    cfg = MultizConfig(batch_fn=yama_batch_packed)
    with jax.default_device(gpu_device):
        blocks = tba_run(
            "(((human chimp) mouse) rat)",
            ["human.chimp.sing.maf", "human.mouse.sing.maf",
             "human.rat.sing.maf"],
            src_dir=DATA, cfg=cfg, sp=sp,
        )
    rendered = "".join(format_ali(a) for a in blocks)
    assert _block_lines(rendered) == _block_lines(_expect("tba4.maf"))


def test_fuzz_multigroup_on_chip(gpu_device):
    """On-card bit-equality with several blocks per launch and several
    buckets, including a wide-band bucket (several 32-column segments
    per row) and tall K/L. Bit-exactness bar: mz_yama.c:138-154
    tie-breaking."""
    import jax
    import numpy as np

    from multiz_jax import yama as Y
    from multiz_jax.ops import yama_pack as YP
    from multiz_jax.ops.synth import synth_jobs

    # bucket 1: sizes ~90-120 (one padded shape, 67 warps)
    jobs = synth_jobs(67, m_lo=90, m_hi=120, k_lo=1, k_hi=4,
                      radius=30, seed=101)
    # bucket 2: a clearly different padded shape
    jobs += synth_jobs(5, m_lo=200, m_hi=240, k_lo=1, k_hi=2,
                       radius=30, seed=102)
    # wide bands (1024 rung) and tall blocks
    jobs += synth_jobs(5, m_lo=300, m_hi=340, radius=140, seed=103)
    jobs += synth_jobs(5, m_lo=150, m_hi=400, k_lo=4, k_hi=8, radius=12,
                       seed=104)
    with jax.default_device(gpu_device):
        got = YP.yama_batch_packed(jobs, core="cuda", host_threads=0,
                                   host_route=0)
    assert len(got) == len(jobs)
    for i, ((A, B, LB, RB), out) in enumerate(zip(jobs, got)):
        want = Y.yama_numpy(A, B, LB, RB)
        np.testing.assert_array_equal(out, want, err_msg=f"job {i}")
