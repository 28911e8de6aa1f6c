"""pre_yama2 + connectionAgreement2 vs the reference C oracle.

These functions are dead code in the reference's *built* binaries, so the
oracle is a purpose-built harness (tests/tools/pre_yama2_harness.c) over
the reference sources. Goldens are generated by running this module as a
script (see __main__), which writes the scenario MAFs into
tests/golden/data/prey2/ and the harness outputs into
tests/golden/expect/prey2_<case>.txt; the test rebuilds the identical
scenarios and compares our pre_yama2 output byte-for-byte.

Scenario shape (all ungapped so the bridge's must_equal cross-checks are
trivially satisfiable): a bridge human-mouse block dictates the column
correspondence; a2 is a human-topped block, a3 a mouse-topped block with
a rat row; per-species pairwise support files gate the merge at >=50%
(align_util.c:520-659).
"""

import io
import os
import subprocess

import numpy as np
import pytest

from multiz_jax import scores as sc
from multiz_jax.align_util import PwUAliFiles, connection_agreement2
from multiz_jax.maf import Ali, Comp, format_ali, read_maf, pos2col
from multiz_jax.preyama import pre_yama2

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
DATA = os.path.join(GOLDEN, "data", "prey2")
EXPECT = os.path.join(GOLDEN, "expect")

RNG_SEED = 77


def _seq(rng, n):
    return rng.choice(np.frombuffer(b"ACGT", dtype=np.uint8), size=n)


def _block(rows):
    """rows: list of (src, start, size, strand, src_size, text bytes)."""
    a = Ali()
    for src, start, size, strand, src_size, text in rows:
        a.comps.append(
            Comp(src=src, start=start, size=size, strand=strand,
                 src_size=src_size, text=np.asarray(text, np.uint8))
        )
    a.score = sc.score_range(a, 0, a.text_size)
    return a


def _write(path, blocks):
    with open(path, "w") as fh:
        fh.write("##maf version=1 scoring=tst\n")
        for b in blocks:
            fh.write(format_ali(b))
        fh.write("##eof maf\n")


def _revcomp(t):
    comp = dict(zip(b"ACGT", b"TGCA"))
    return np.asarray([comp[int(x)] for x in t[::-1]], np.uint8)


def build_scenarios(dirpath):
    """Write scenario MAFs; return {case: (args for pre_yama2)}."""
    os.makedirs(dirpath, exist_ok=True)
    rng = np.random.default_rng(RNG_SEED)
    H = _seq(rng, 1000)
    Mo = _seq(rng, 1000)
    R = _seq(rng, 1000)
    Ch = _seq(rng, 1000)

    def hrow(lo, hi):
        return ("human.chr1", lo, hi - lo, "+", 1000, H[lo:hi])

    def mrow(lo, hi):
        return ("mouse.chr1", lo, hi - lo, "+", 1000, Mo[lo:hi])

    bridge = _block([hrow(100, 300), mrow(120, 320)])
    _write(os.path.join(dirpath, "bridge.maf"), [bridge])

    cases = {}

    # ---- case A: accept; a2 = 1 human row, a3 = mouse+rat ----
    a2 = _block([hrow(80, 350)])
    a3 = _block([mrow(100, 360),
                 ("rat.chr1", 150, 260, "+", 1000, R[150:410])])
    _write(os.path.join(dirpath, "a2_A.maf"), [a2])
    _write(os.path.join(dirpath, "a3_A.maf"), [a3])
    _write(os.path.join(dirpath, "human.mouse.tst.maf"), [bridge])
    # colinear human-rat support: human[100,300) ~ rat[160,360)
    hr = _block([hrow(100, 300),
                 ("rat.chr1", 160, 200, "+", 1000, R[160:360])])
    _write(os.path.join(dirpath, "human.rat.tst.maf"), [hr])
    cases["A"] = ("a2_A.maf", "a3_A.maf", "human", "mouse rat",
                  100, 299, 120, 319)

    # ---- case B: reject; both supports displaced far off-diagonal ----
    hm_far = _block([("human.chr1", 600, 200, "+", 1000, H[600:800]),
                 mrow(120, 320)])
    os.makedirs(os.path.join(dirpath, "rej"), exist_ok=True)
    _write(os.path.join(dirpath, "rej", "human.mouse.tst.maf"), [hm_far])
    hr2 = _block([("human.chr1", 600, 200, "+", 1000, H[600:800]),
                  ("rat.chr1", 160, 200, "+", 1000, R[160:360])])
    _write(os.path.join(dirpath, "rej", "human.rat.tst.maf"), [hr2])
    cases["B"] = ("a2_A.maf", "a3_A.maf", "human", "mouse rat",
                  100, 299, 120, 319)

    # ---- case C: '-' strand pairwise support (marker2 path) ----
    os.makedirs(os.path.join(dirpath, "neg"), exist_ok=True)
    _write(os.path.join(dirpath, "neg", "human.mouse.tst.maf"), [bridge])
    hr3 = _block([
        ("human.chr1", 1000 - 300, 200, "-", 1000, _revcomp(H[100:300])),
        ("rat.chr1", 1000 - 360, 200, "-", 1000, _revcomp(R[160:360])),
    ])
    _write(os.path.join(dirpath, "neg", "human.rat.tst.maf"), [hr3])
    cases["C"] = ("a2_A.maf", "a3_A.maf", "human", "mouse rat",
                  100, 299, 120, 319)

    # ---- case D: a2 has a '-' chimp row (marker1 path in CA2) ----
    a2d = _block([hrow(80, 350),
                  ("chimp.chr1", 1000 - 400, 270, "-", 1000,
                   _revcomp(Ch[130:400]))])
    _write(os.path.join(dirpath, "a2_D.maf"), [a2d])
    a3d = _block([mrow(100, 360)])
    _write(os.path.join(dirpath, "a3_D.maf"), [a3d])
    # supports: human-mouse = bridge; chimp-mouse colinear with chimp's
    # plus-oriented interval [600, 870)
    cm = _block([("chimp.chr1", 610, 200, "+", 1000, Ch[610:810]),
                 mrow(120, 320)])
    os.makedirs(os.path.join(dirpath, "d"), exist_ok=True)
    _write(os.path.join(dirpath, "d", "human.mouse.tst.maf"), [bridge])
    _write(os.path.join(dirpath, "d", "chimp.mouse.tst.maf"), [cm])
    cases["D"] = ("a2_D.maf", "a3_D.maf", "human chimp", "mouse",
                  100, 299, 120, 319)

    return cases


CASE_DIRS = {"A": ".", "B": "rej", "C": "neg", "D": "d"}


def _run_ours(dirpath, case, cases):
    a2f, a3f, left, right, beg1, end1, begN, endN = cases[case]
    sub = os.path.join(dirpath, CASE_DIRS[case])
    sp = sc.init_scores70()
    a2 = read_maf(os.path.join(dirpath, a2f), verbose=False)[0]
    a3 = read_maf(os.path.join(dirpath, a3f), verbose=False)[0]
    a1 = read_maf(os.path.join(dirpath, "bridge.maf"), verbose=False)[0]
    pws = PwUAliFiles(left.split(), right.split(), "tst.maf", src_dir=sub)
    val = pre_yama2(a1, a2, a3, beg1, end1, begN, endN, 30, pws, sp=sp)
    return "NULL\n" if val is None else format_ali(val)


@pytest.mark.parametrize("case", ["A", "B", "C", "D"])
def test_pre_yama2_golden(case, tmp_path):
    cases = build_scenarios(str(tmp_path))
    got = _run_ours(str(tmp_path), case, cases)
    with open(os.path.join(EXPECT, f"prey2_{case}.txt")) as fh:
        want = fh.read()
    assert got == want


if __name__ == "__main__":
    # golden generation: build scenarios in tests/golden/data/prey2 and
    # run the reference harness (assumed at /tmp/refbuild)
    here = os.path.dirname(os.path.abspath(__file__))
    data = os.path.join(here, "golden", "data", "prey2")
    cases = build_scenarios(data)
    harness = "/tmp/refbuild/pre_yama2_harness"
    for case, (a2f, a3f, left, right, b1, e1, bN, eN) in cases.items():
        sub = os.path.join(data, CASE_DIRS[case])
        res = subprocess.run(
            [harness, os.path.join(data, a2f), os.path.join(data, a3f),
             os.path.join(data, "bridge.maf"), left, right, "tst.maf",
             str(b1), str(e1), str(bN), str(eN), "30"],
            capture_output=True, cwd=sub, text=True,
        )
        if res.returncode != 0:
            print(case, "HARNESS FAILED:", res.stderr[-400:])
            continue
        out = os.path.join(here, "golden", "expect", f"prey2_{case}.txt")
        with open(out, "w") as fh:
            fh.write(res.stdout)
        print("wrote", out, len(res.stdout), "bytes")


DATA0 = os.path.join(GOLDEN, "data")


def test_mark_infered_pws_golden():
    """mark_infered_pws + print_unused_ali vs the C harness
    (align_util.c:662-758, 144-169): multi-blocks explain pairwise
    regions; unexplained runs are emitted."""
    from multiz_jax.align_util import (
        PwUAliFiles, form_name_list, mark_infered_pws,
    )
    from multiz_jax.maf import read_maf

    sc.init_scores70()
    nlist = read_maf(
        os.path.join(DATA0, "prey2", "nlist_partial.maf"), verbose=False
    )
    pws = PwUAliFiles(form_name_list("human"),
                      form_name_list("chimp mouse"), "sing.maf",
                      src_dir=DATA0)
    mark_infered_pws(nlist, pws)
    out = io.StringIO()
    from multiz_jax.align_util import print_unused_ali

    for i, f in enumerate(pws.files):
        out.write(f"## pairfile {i}: {f.filename}\n")
        for u in f.ualis:
            print_unused_ali(u, lambda a: out.write(format_ali(a)))
    with open(os.path.join(EXPECT, "au_mark.txt")) as fh:
        want = fh.read()
    assert out.getvalue() == want


def test_find_exemplar_golden():
    """Find_Exemplar greedy cover vs the C harness
    (align_util.c:760-832)."""
    from multiz_jax.align_util import UAliFile, find_exemplar
    from multiz_jax.maf import read_maf

    sc.init_scores70()
    blocks = read_maf(os.path.join(DATA0, "multi.maf"), verbose=False)
    uf = UAliFile(blocks)
    sal = uf.sorted["mouse"]
    cover, start = find_exemplar(sal, "mouse.chr1", 2000, 9000, 0)
    out = io.StringIO()
    out.write(f"## startIndex {start}\n")
    for u in cover:
        out.write(format_ali(u.ali))
    with open(os.path.join(EXPECT, "au_exemplar.txt")) as fh:
        want = fh.read()
    assert out.getvalue() == want
