"""MAF parse/serialize byte-exactness against reference-produced files."""

import io
import os

import numpy as np

from multiz_jax import maf

from .conftest import GOLDEN

DATA = os.path.join(GOLDEN, "data")
EXPECT = os.path.join(GOLDEN, "expect")


def roundtrip(path: str) -> None:
    """Re-serializing every parsed block must reproduce the block lines."""
    with open(path, "rb") as fh:
        raw = fh.read()
    if not raw.startswith(b"##maf"):
        # multiz's out1/out2 unused files carry no header (multiz.c:241-245)
        raw = b"##maf version=1 scoring=x\n" + raw
    echo = io.StringIO()
    alis = maf.parse_maf_bytes(raw, verbose=True, echo=echo, file_name=path)
    out = "".join(maf.format_ali(a) for a in alis)
    # reference-written files: strip header/comment/eof lines, keep blocks
    keep = []
    for line in raw.decode("latin-1").split("\n"):
        if line.startswith("#") or line.startswith(" "):
            continue
        keep.append(line)
    want = "\n".join(keep)
    # normalize runs of blank lines (parser is insensitive to them)
    wantb = [l for l in want.split("\n") if l]
    gotb = [l for l in out.split("\n") if l]
    assert gotb == wantb, f"roundtrip mismatch for {path}"


def test_roundtrip_sing():
    for f in os.listdir(DATA):
        if f.endswith(".maf"):
            roundtrip(os.path.join(DATA, f))


def test_roundtrip_expect():
    for f in os.listdir(EXPECT):
        # pair2tb_encode.maf reproduces a reference quirk block whose
        # claimed size exceeds its text (maftop2tb.c:135-142); neither
        # parser accepts it back (maf.c:186-211 would fatal too)
        if f.endswith(".maf") and f != "pair2tb_encode.maf":
            roundtrip(os.path.join(EXPECT, f))


def test_pos2col():
    text = np.frombuffer(b"A--CG-T", dtype=np.uint8)
    c = maf.Comp("h.c1", 10, 4, "+", 100, text.copy())
    assert maf.pos2col(c, 10) == 0
    assert maf.pos2col(c, 11) == 3
    assert maf.pos2col(c, 12) == 4
    assert maf.pos2col(c, 13) == 6
    assert maf.col2pos_after(c, 1) == 11
    assert maf.col2pos_before(c, 1) == 10
    assert maf.col2pos_before(c, 0) == 10
    assert maf.col2pos_after(c, 6) == 13


def test_score_line_parse():
    raw = (b"##maf version=1 scoring=x\n\n"
           b"a score=125.0 copy=1\n"
           b"s a.c 0 3 + 10 ACG\n"
           b"s b.c 0 3 + 10 ACG\n\n"
           b"##eof maf\n")
    alis = maf.parse_maf_bytes(raw)
    assert len(alis) == 1
    assert alis[0].score == 125.0
    assert alis[0].comps[1].paralog == "c"
    s = maf.format_ali(alis[0])
    assert s.startswith("a score=125.0 copy=1\n")
