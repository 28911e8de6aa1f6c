"""Pairwise front-end tools vs reference goldens."""

import io
import os

import pytest

from multiz_jax.cli import (
    get_covered as cli_gc,
    maf_order as cli_mo,
    maf_sort as cli_ms,
    pair2tb as cli_p2,
    single_cov2 as cli_sc,
)

from .conftest import GOLDEN

DATA = os.path.join(GOLDEN, "data")
EXPECT = os.path.join(GOLDEN, "expect")


def read(path):
    with open(path) as fh:
        return fh.read()


def strip_args(text, prefix="# single_cov2"):
    return "\n".join(
        l for l in text.split("\n") if not l.startswith(prefix)
    )


@pytest.mark.parametrize("sp", ["chimp", "mouse", "rat"])
@pytest.mark.parametrize("mode", ["", "R=human"])
def test_single_cov2(sp, mode):
    out, err = io.StringIO(), io.StringIO()
    argv = [os.path.join(DATA, f"human.{sp}.orig.maf")] + (
        [mode] if mode else []
    )
    cli_sc.main(argv, out=out, err=err)
    suffix = "singR" if mode else "sing"
    want = read(os.path.join(EXPECT, f"human.{sp}.{suffix}.maf"))
    assert strip_args(out.getvalue()) == strip_args(want)


def test_maf_sort():
    out = io.StringIO()
    cli_ms.main([os.path.join(DATA, "human.mouse.sing.maf"), "mouse"], out=out)
    assert out.getvalue() == read(os.path.join(EXPECT, "mouse_sorted.maf"))


def test_maf_order():
    out = io.StringIO()
    cli_mo.main(
        [os.path.join(DATA, "human.mouse.sing.maf"), "mouse", "human", "all"],
        out=out,
    )
    assert out.getvalue() == read(os.path.join(EXPECT, "mouse_ordered.maf"))


def test_get_covered():
    out = io.StringIO()
    cli_gc.main(
        [
            os.path.join(DATA, "human.chimp.sing.maf"),
            os.path.join(DATA, "human.mouse.sing.maf"),
        ],
        out=out,
    )
    assert out.getvalue() == read(os.path.join(EXPECT, "get_covered.maf"))


def test_pair2tb(monkeypatch):
    monkeypatch.chdir(DATA)
    out = io.StringIO()
    cli_p2.main(["human.chimp.sing.maf", "human", "chimp"], out=out)
    assert out.getvalue() == read(os.path.join(EXPECT, "pair2tb.maf"))


def test_seq_filename_spec(capsys):
    """seqfile{mask}[from,to]- syntax (parse_fname, seq.c:282-324):
    subrange limits reading to the first contig; trailing '-' revcomps;
    {maskfile} parses but is inert in this version (seq.c:238 checks
    SEQ_HAS_MASK which nothing sets before the first read)."""
    import numpy as np

    from multiz_jax.cli import get_standard_headers as gsh
    from multiz_jax.seqio import read_fasta, read_fasta_spec

    two = os.path.join(DATA, "two.fa")
    for spec, golden in (
        (two + "[3,8]", "spec_range.txt"),
        (two + "-", "spec_rc.txt"),
        (two + "{nomask}[3,8]-", "spec_all.txt"),
    ):
        out = io.StringIO()
        gsh.main([spec], out=out)
        assert out.getvalue() == read(os.path.join(EXPECT, golden)), spec
    # content semantics: revcomp of the plain read (dna_complement table)
    plain = read_fasta(two)
    rc = read_fasta_spec(two + "-")
    compl = dict(zip(b"ACGT", b"TGCA"))
    want = bytes(compl[int(x)] for x in plain[0].seq[::-1])
    assert rc[0].seq.tobytes() == want
    sub = read_fasta_spec(two + "[3,8]")
    assert len(sub) == 1
    assert np.array_equal(sub[0].seq, plain[0].seq[2:8])


def test_pair2tb_encode_headers():
    """17-separator ENCODE/MSA FASTA headers (parseMSAHeader,
    multi_util.c:261-299): form 1 (fields 7/8/10/11) on the reference
    side, form 2 (fields 15/13/11) on the species side."""
    from multiz_jax.cli import pair2tb as p2t_cli

    out = io.StringIO()
    p2t_cli.main(
        [
            os.path.join(DATA, "human.chimp.sing.maf"),
            os.path.join(DATA, "human_encode"),
            os.path.join(DATA, "chimp_encode"),
        ],
        out=out,
    )
    want = read(os.path.join(EXPECT, "pair2tb_encode.maf"))
    got = out.getvalue()
    strip = lambda t: [  # noqa: E731
        l for l in t.split("\n") if not l.startswith("#")
    ]
    assert strip(got) == strip(want)
