"""multiz end-to-end vs reference goldens (byte-exact)."""

import io
import os

import pytest

from multiz_jax.cli import multiz as cli

from .conftest import GOLDEN

DATA = os.path.join(GOLDEN, "data")
EXPECT = os.path.join(GOLDEN, "expect")
F1 = os.path.join(DATA, "human.chimp.sing.maf")
F2 = os.path.join(DATA, "human.mouse.sing.maf")


def run_cli(argv):
    out = io.StringIO()
    cli.main(argv, out=out)
    return out.getvalue()


def read(path):
    with open(path) as fh:
        return fh.read()


def strip_argline(text: str) -> str:
    return "\n".join(
        l for l in text.split("\n") if not l.startswith("# multiz.v")
    )


@pytest.mark.parametrize("v", [0, 1])
def test_multiz_interleaved(v):
    got = run_cli([F1, F2, str(v)])
    want = read(os.path.join(EXPECT, f"multiz_v{v}.maf"))
    assert got == want  # byte-identical incl. comment echo and arg line


@pytest.mark.parametrize("v", [0, 1])
def test_multiz_deferred_batch_path(v, monkeypatch):
    """Two-phase plan/execute/stitch (MultizConfig.batch_fn) is
    byte-identical to the inline scan (reference multiz.c:60-177)."""
    monkeypatch.setenv("MULTIZ_DEVICE", "host")
    got = run_cli([F1, F2, str(v)])
    want = read(os.path.join(EXPECT, f"multiz_v{v}.maf"))
    assert got == want


def test_multiz_deferred_batch_path_jax(monkeypatch):
    """Same, executing the plan through the streaming device executor
    over the plain XLA core, with every DP on the device."""
    monkeypatch.setenv("MULTIZ_DEVICE", "jax")
    monkeypatch.setenv("MZ_HOST_ROUTE_CELLS", "0")
    monkeypatch.setenv("MZ_HOST_DP_THREADS", "0")
    got = run_cli([F1, F2, "0"])
    want = read(os.path.join(EXPECT, "multiz_v0.maf"))
    assert got == want


def test_multiz_separate_outputs(tmp_path):
    u1 = str(tmp_path / "u1.maf")
    u2 = str(tmp_path / "u2.maf")
    got = run_cli([F1, F2, "1", u1, u2])
    want = read(os.path.join(EXPECT, "multiz_v1_main.maf"))
    assert strip_argline(got) == strip_argline(want)
    assert read(u1) == read(os.path.join(EXPECT, "multiz_v1_u1.maf"))
    assert read(u2) == read(os.path.join(EXPECT, "multiz_v1_u2.maf"))


def test_single_row_a2_overlap():
    """pre_yama with a single-row a2 (L=0, e.g. a pair2tb gap filler):
    the (N, 0) columns are vacuously all-dash, so the DP is skipped and
    the merge emits nothing for the overlap — verified byte-equal to
    the reference binary (mz_preyama.c:94-98 with row==0, :183-188).
    Regression: r4's 20Mb 2-chromosome run crashed on np.stack([])."""
    import io

    from multiz_jax.cli import multiz as cli

    m1 = (
        "##maf version=1 scoring=blastz\n"
        "a score=100.0\n"
        "s human.chr1 10 20 + 1000 ACGTACGTACGTACGTACGT\n"
        "s chimp.chr1 5 20 + 900 ACGTACGTACGTACGTACGT\n\n"
    )
    m2 = (
        "##maf version=1 scoring=blastz\n"
        "a score=0.0\n"
        "s human.chr1 15 10 + 1000 GTACGTACGT\n\n"
    )
    import tempfile

    with tempfile.TemporaryDirectory() as d:
        p1 = os.path.join(d, "a.maf")
        p2 = os.path.join(d, "b.maf")
        open(p1, "w").write(m1)
        open(p2, "w").write(m2)
        out = io.StringIO()
        rc = cli.main([p1, p2, "1"], out=out)
    assert rc in (0, None)
    body = [
        l for l in out.getvalue().splitlines()
        if l and not l.startswith("#")
    ]
    # reference output: both blocks pass through unmerged (a score=100
    # block first, then the overlap-stripped single-row pieces)
    assert any("chimp.chr1" in l for l in body)
