"""Golden-fixture generator.

Builds the reference multiz/TBA C sources (expected at $MULTIZ_REF, default
/root/reference) in a scratch directory and runs the reference binaries on
synthetic inputs to produce golden outputs committed under tests/golden/.
Tests never invoke the reference directly; they compare against the
committed fixtures, so the suite is self-contained.

Usage: python tests/make_golden.py [all|yama|data|tools|tree]
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
GOLDEN = os.path.join(HERE, "golden")
REF = os.environ.get("MULTIZ_REF", "/root/reference")
BUILD = os.environ.get("MULTIZ_REF_BUILD", "/tmp/mz_refbuild")

sys.path.insert(0, REPO)

from tests.sim import SimConfig, simulate  # noqa: E402


def build_reference() -> str:
    """Compile the reference toolchain with -fcommon (modern gcc)."""
    os.makedirs(BUILD, exist_ok=True)
    for f in os.listdir(REF):
        if f.endswith((".c", ".h")) or f == "Makefile":
            shutil.copy(os.path.join(REF, f), BUILD)
    subprocess.run(
        ["make", "CFLAGS=-O2 -fcommon -w"],
        cwd=BUILD,
        check=True,
        capture_output=True,
    )
    # yama harness
    srcs = (
        "util.c maf.c multi_util.c mz_scores.c mz_yama.c seq.c nib.c "
        "charvec.c".split()
    )
    subprocess.run(
        ["gcc", "-O2", "-fcommon", "-w", "-I.",
         os.path.join(HERE, "tools", "yama_harness.c"), *srcs,
         "-o", "yama_harness"],
        cwd=BUILD,
        check=True,
    )
    return BUILD


def run_ref(tool, *args, stdin=None, cwd=None, check=True):
    res = subprocess.run(
        [os.path.join(BUILD, tool), *map(str, args)],
        input=stdin,
        capture_output=True,
        cwd=cwd,
    )
    if check and res.returncode != 0:
        raise RuntimeError(
            f"{tool} {args} failed: {res.stderr[-2000:]!r}"
        )
    return res


# ------------------------------------------------------------------
# yama fuzz fixtures
# ------------------------------------------------------------------

ALPHA = np.frombuffer(b"ACGTacgtNn-", dtype=np.uint8)


def _gen_band(M, N, r, rng):
    LB = np.zeros(M + 1, dtype=np.int64)
    RB = np.full(M + 1, N, dtype=np.int64)
    if rng.random() < 0.6 and M > 0:
        for i in range(M + 1):
            c = i * N // max(M, 1)
            LB[i] = max(0, c - r)
            RB[i] = min(N, c + r)
        LB = np.maximum.accumulate(LB)
        RB = np.minimum.accumulate(RB[::-1])[::-1]
        wmin = min(N, 10)
        RB = np.maximum(RB, np.minimum(LB + wmin, N))
        LB = np.minimum(LB, np.maximum(RB - wmin, 0))
        LB = np.maximum.accumulate(LB)
        RB = np.maximum.accumulate(RB)
        LB[0] = 0
        RB[M] = N
        RB = np.maximum.accumulate(RB)
        LB = np.minimum(LB, RB)
    return LB, RB


def make_yama_fixtures(n_cases=64, seed=123):
    from multiz_jax import yama as Y

    rng = np.random.default_rng(seed)
    out = {}
    count = 0
    trial = 0
    while count < n_cases:
        trial += 1
        K = int(rng.integers(1, 7))
        L = int(rng.integers(1, 7))
        M = int(rng.integers(2, 120))
        N = int(rng.integers(2, 120))
        A = ALPHA[rng.integers(0, len(ALPHA), size=(M, K))]
        B = ALPHA[rng.integers(0, len(ALPHA), size=(N, L))]
        LB, RB = _gen_band(M, N, int(rng.integers(2, 20)), rng)
        try:
            Y._check_band(LB, RB, M, N)
        except Y.YamaError:
            continue
        inp = [f"{K} {M} {L} {N}",
               " ".join(map(str, LB)), " ".join(map(str, RB))]
        inp += [A[i].tobytes().decode() for i in range(M)]
        inp += [B[i].tobytes().decode() for i in range(N)]
        res = run_ref(
            "yama_harness", stdin=("\n".join(inp) + "\n").encode(),
            check=False,
        )
        if res.returncode != 0:
            # some synthetic bands are not traceback-connected; the real
            # pipeline only produces smooth() sausage bands
            continue
        lines = res.stdout.decode().strip().split("\n")
        m_new = int(lines[0])
        ref = np.array(
            [np.frombuffer(l.encode(), np.uint8) for l in lines[1:1 + m_new]]
        )
        out[f"case{count}_A"] = A
        out[f"case{count}_B"] = B
        out[f"case{count}_LB"] = LB
        out[f"case{count}_RB"] = RB
        out[f"case{count}_out"] = ref
        count += 1
    out["n_cases"] = np.array(n_cases)
    np.savez_compressed(os.path.join(GOLDEN, "yama_fuzz.npz"), **out)
    print(f"wrote yama_fuzz.npz ({n_cases} cases)")


# ------------------------------------------------------------------
# synthetic MAF data + reference-tool goldens
# ------------------------------------------------------------------


def make_data():
    """Simulate a small species set; write inputs under tests/golden/data."""
    data = os.path.join(GOLDEN, "data")
    os.makedirs(data, exist_ok=True)
    simulate(SimConfig(seed=11, ref_len=20000), data)
    print("wrote synthetic data")


def make_tool_goldens():
    data = os.path.join(GOLDEN, "data")
    out = os.path.join(GOLDEN, "expect")
    os.makedirs(out, exist_ok=True)

    def save(name, res):
        with open(os.path.join(out, name), "wb") as fh:
            fh.write(res.stdout)

    # single_cov2 on raw (overlapping) pairwise mafs
    for sp in ("chimp", "mouse", "rat"):
        res = run_ref("single_cov2", os.path.join(data, f"human.{sp}.orig.maf"))
        save(f"human.{sp}.sing.maf", res)
        with open(os.path.join(data, f"human.{sp}.sing.maf"), "wb") as fh:
            fh.write(res.stdout)
        res = run_ref(
            "single_cov2", os.path.join(data, f"human.{sp}.orig.maf"),
            "R=human",
        )
        save(f"human.{sp}.singR.maf", res)

    # maf_sort / maf_order
    res = run_ref(
        "maf_sort", os.path.join(data, "human.mouse.sing.maf"), "mouse"
    )
    save("mouse_sorted.maf", res)
    res = run_ref(
        "maf_order", os.path.join(data, "human.mouse.sing.maf"),
        "mouse", "human", "all",
    )
    save("mouse_ordered.maf", res)

    # multiz v=1 and v=0 on two sing mafs
    for v in (0, 1):
        res = run_ref(
            "multiz",
            os.path.join(data, "human.chimp.sing.maf"),
            os.path.join(data, "human.mouse.sing.maf"),
            v,
        )
        save(f"multiz_v{v}.maf", res)
        if v == 1:  # reused as the multi-block input for maf_project tests
            with open(os.path.join(data, "multi.maf"), "wb") as fh:
                fh.write(res.stdout)

    # multiz with separate unused-output files
    tmp = os.path.join(BUILD, "mz_out")
    os.makedirs(tmp, exist_ok=True)
    res = run_ref(
        "multiz",
        os.path.join(data, "human.chimp.sing.maf"),
        os.path.join(data, "human.mouse.sing.maf"),
        1,
        os.path.join(tmp, "u1.maf"),
        os.path.join(tmp, "u2.maf"),
    )
    save("multiz_v1_main.maf", res)
    for f in ("u1.maf", "u2.maf"):
        shutil.copy(os.path.join(tmp, f), os.path.join(out, f"multiz_v1_{f}"))

    # get_covered
    res = run_ref(
        "get_covered",
        os.path.join(data, "human.chimp.sing.maf"),
        os.path.join(data, "human.mouse.sing.maf"),
    )
    save("get_covered.maf", res)

    # pair2tb (needs sequence files in cwd)
    res = run_ref(
        "pair2tb", os.path.join(data, "human.chimp.sing.maf"),
        "human", "chimp", cwd=data,
    )
    save("pair2tb.maf", res)

    # maf_project
    res = run_ref(
        "maf_project", os.path.join(data, "multi.maf"), "human",
    )
    save("maf_project_human.maf", res)
    res = run_ref(
        "maf_project", os.path.join(data, "multi.maf"), "mouse",
    )
    save("maf_project_mouse.maf", res)
    print("wrote tool goldens")


def make_multic_goldens():
    """multic on overlapping (orig) and single-coverage inputs."""
    data = os.path.join(GOLDEN, "data")
    out = os.path.join(GOLDEN, "expect")

    def save(name, res):
        with open(os.path.join(out, name), "wb") as fh:
            fh.write(res.stdout)

    for v in (0, 1):
        res = run_ref(
            "multic",
            os.path.join(data, "human.chimp.sing.maf"),
            os.path.join(data, "human.mouse.orig.maf"),
            v,
        )
        save(f"multic_v{v}.maf", res)
    tmp = os.path.join(BUILD, "mc_out")
    os.makedirs(tmp, exist_ok=True)
    res = run_ref(
        "multic",
        os.path.join(data, "human.chimp.orig.maf"),
        os.path.join(data, "human.rat.orig.maf"),
        1,
        os.path.join(tmp, "u1.maf"),
        os.path.join(tmp, "u2.maf"),
    )
    save("multic_v1_main.maf", res)
    for f in ("u1.maf", "u2.maf"):
        shutil.copy(os.path.join(tmp, f), os.path.join(out, f"multic_v1_{f}"))
    print("wrote multic goldens")


def make_lav_goldens():
    """maf2lav on a sing maf, then lav2maf round-trip, both as goldens."""
    data = os.path.join(GOLDEN, "data")
    out = os.path.join(GOLDEN, "expect")
    res = run_ref(
        "maf2lav", "human.chimp.sing.maf", "human", "chimp", cwd=data,
    )
    lav_path = os.path.join(out, "human.chimp.lav")
    with open(lav_path, "wb") as fh:
        fh.write(res.stdout)
    res = run_ref("lav2maf", lav_path, "human", "chimp", cwd=data)
    with open(os.path.join(out, "lav2maf.maf"), "wb") as fh:
        fh.write(res.stdout)
    print("wrote lav goldens")


M2F_CASES = [
    ("m2f_text.txt", ["human", "multi.maf"]),
    ("m2f_fasta.fa", ["human", "multi.maf", "fasta"]),
    ("m2f_fasta2.fa", ["human", "multi.maf", "fasta2@"]),
    ("m2f_range.fa", ["human", "multi.maf", "100", "5000", "fasta#"]),
    ("m2f_refsrc.fa", ["human", "multi.maf", "refsrc=human.chr1", "fasta"]),
    ("m2f_pair.txt", ["human", "human.chimp.sing.maf"]),
]


def make_maf2fasta_goldens():
    data = os.path.join(GOLDEN, "data")
    out = os.path.join(GOLDEN, "expect")
    for name, args in M2F_CASES:
        res = run_ref("maf2fasta", *args, cwd=data)
        with open(os.path.join(out, name), "wb") as fh:
            fh.write(res.stdout)
    res = run_ref("get_standard_headers", "human", cwd=data)
    with open(os.path.join(out, "standard_headers.txt"), "wb") as fh:
        fh.write(res.stdout)
    print("wrote maf2fasta goldens")


BZW_CANNED_LAV = """#:lav
d {
  "lastz /dev/stdin two.fa Y=9000"
}
#:lav
s {
  "one.fa" 1 500 0 1
  "two.fa" 1 400 0 1
}
h {
  ">contigA"
  ">contigB"
}
a {
  s 1000
  b 10 20
  e 110 120
  l 10 20 60 70 95
  l 61 71 110 120 90
}
x {
  n 0
}
#:eof
"""

ALL_BZ_SPEC = """# sample specfile
#define MAMMAL human baboon

* : *
\tY=3400
MAMMAL : MAMMAL
\tC=2 B=0
"""

ALL_BZ_DRY_CASES = [
    ("all_bz_dry_tba.txt",
     ["-", "(((human chimp) baboon) (mouse rat))", "SPEC"]),
    ("all_bz_dry_roast.txt",
     ["-", "D=0", "F=human", "((human chimp) mouse)"]),
    ("all_bz_dry_ref.txt",
     ["-", "F=human", "((human chimp) mouse)", "SPEC"]),
]


def _write_fake_lastz(dirpath):
    """A stand-in lastz: emits the golden human.chimp lav for that pair,
    the canned 2-contig lav fixture for one.fa/two.fa, else empty lav."""
    out = os.path.join(GOLDEN, "expect")
    path = os.path.join(dirpath, "lastz")
    with open(path, "w") as fh:
        fh.write(
            "#!/bin/sh\n"
            "cat /dev/stdin > /dev/null 2>/dev/null || true\n"
            'case "$1 $2" in\n'
            f'  *chimp*) cat {os.path.join(out, "human.chimp.lav")} ;;\n'
            f'  *two.fa*) cat {os.path.join(GOLDEN, "data", "canned.lav")} '
            ";;\n"
            '  *) echo "#:lav"; echo "#:eof" ;;\n'
            "esac\n"
        )
    os.chmod(path, 0o755)
    return dirpath


def make_all_bz_goldens():
    """all_bz dry-run command goldens + blastzWrapper rewrite goldens
    (driven by a fake lastz so no real aligner is needed)."""
    data = os.path.join(GOLDEN, "data")
    out = os.path.join(GOLDEN, "expect")
    spec = os.path.join(data, "bz_spec")
    with open(spec, "w") as fh:
        fh.write(ALL_BZ_SPEC)
    with open(os.path.join(data, "canned.lav"), "w") as fh:
        fh.write(BZW_CANNED_LAV)
    with open(os.path.join(data, "two.fa"), "w") as fh:
        fh.write(">c1\nACGTACGTAC\n>c2\nTTTTACGTGG\n")
    with open(os.path.join(data, "one.fa"), "w") as fh:
        fh.write(">only\nACGTACGTACGT\n")

    for name, args in ALL_BZ_DRY_CASES:
        args = [spec if a == "SPEC" else a for a in args]
        res = run_ref("all_bz", *args, cwd=data)
        with open(os.path.join(out, name), "wb") as fh:
            fh.write(res.stdout)

    fake = os.path.join(BUILD, "fakebin")
    os.makedirs(fake, exist_ok=True)
    _write_fake_lastz(fake)
    env = dict(os.environ, PATH=fake + ":" + os.environ.get("PATH", ""))
    for tag, pair in (
        ("fwd", ["one.fa", "two.fa"]),
        ("rev", ["two.fa", "one.fa"]),
        ("multi", ["two.fa", "two.fa"]),
    ):
        res = subprocess.run(
            [os.path.join(BUILD, "blastzWrapper"), *pair, "Y=9000"],
            capture_output=True, cwd=data, env=env,
        )
        with open(os.path.join(out, f"bzw_{tag}.lav"), "wb") as fh:
            fh.write(res.stdout)
    print("wrote all_bz / blastzWrapper goldens")


def make_tree_goldens():
    """roast/tba shell out to the other binaries by name: run with
    PATH=BUILD and cwd=data so `x.y.sing.maf` and seq files resolve."""
    data = os.path.join(GOLDEN, "data")
    out = os.path.join(GOLDEN, "expect")
    env = dict(os.environ, PATH=BUILD + ":" + os.environ.get("PATH", ""))

    def run_tree(tool, *args):
        return subprocess.run(
            [os.path.join(BUILD, tool), *map(str, args)],
            capture_output=True, cwd=data, env=env,
        )

    # roast needs REF.x.sing.maf for every leaf; tba needs x.y.sing.maf for
    # species pairs joined in the tree. With human/chimp/mouse/rat data we
    # only have human.* pairs, so use a "caterpillar" tree.
    tree = "((human chimp) mouse)"
    pairs = ["human.chimp.sing.maf", "human.mouse.sing.maf"]
    res = run_tree("roast", "E=human", tree, *pairs, "roast_out.maf")
    if res.returncode == 0:
        shutil.move(os.path.join(data, "roast_out.maf"),
                    os.path.join(out, "roast.maf"))
        print("wrote roast golden")
    else:
        print("roast golden skipped:", res.stderr[-500:])
    res = run_tree("tba", tree, *pairs, "tba_out.maf")
    if res.returncode == 0:
        shutil.move(os.path.join(data, "tba_out.maf"),
                    os.path.join(out, "tba.maf"))
        print("wrote tba golden")
    else:
        print("tba golden skipped:", res.stderr[-500:])


def main():
    what = sys.argv[1] if len(sys.argv) > 1 else "all"
    os.makedirs(GOLDEN, exist_ok=True)
    build_reference()
    if what in ("all", "yama"):
        make_yama_fixtures()
    if what in ("all", "data"):
        make_data()
    if what in ("all", "tools"):
        make_tool_goldens()
    if what in ("all", "multic"):
        make_multic_goldens()
    if what in ("all", "lav"):
        make_lav_goldens()
    if what in ("all", "maf2fasta"):
        make_maf2fasta_goldens()
    if what in ("all", "all_bz"):
        make_all_bz_goldens()
    if what in ("all", "tree"):
        make_tree_goldens()


if __name__ == "__main__":
    main()
