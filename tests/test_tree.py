"""tba/roast pipelines vs reference goldens (block-stream equality).

Comparison ignores '#' comment lines: the reference leaks pid-dependent
/tmp paths and intermediate-tool provenance comments into its outputs.
"""

import os

import pytest

from multiz_jax import scores as sc
from multiz_jax.maf import format_ali
from multiz_jax.tree import roast_run, tba_run

from .conftest import GOLDEN

DATA = os.path.join(GOLDEN, "data")
EXPECT = os.path.join(GOLDEN, "expect")

PAIRS3 = ["human.chimp.sing.maf", "human.mouse.sing.maf"]
PAIRS4 = PAIRS3 + ["human.rat.sing.maf"]
TREE3 = "((human chimp) mouse)"
TREE4 = "(((human chimp) mouse) rat)"


def block_lines(text: str):
    return [
        l for l in text.split("\n") if l and not l.startswith("#")
    ]


def render(blocks):
    return "".join(format_ali(a) for a in blocks)


def expect(name):
    with open(os.path.join(EXPECT, name)) as fh:
        return block_lines(fh.read())


def test_tba_3species():
    sp = sc.init_scores70()
    blocks = tba_run(TREE3, PAIRS3, src_dir=DATA, sp=sp)
    assert block_lines(render(blocks)) == expect("tba.maf")


def test_roast_3species():
    sp = sc.init_scores70()
    blocks = roast_run("human", TREE3, PAIRS3, src_dir=DATA, sp=sp)
    assert block_lines(render(blocks)) == expect("roast.maf")


def test_tba_4species():
    sp = sc.init_scores70()
    blocks = tba_run(TREE4, PAIRS4, src_dir=DATA, sp=sp)
    assert block_lines(render(blocks)) == expect("tba4.maf")


def test_roast_4species():
    sp = sc.init_scores70()
    blocks = roast_run("human", TREE4, PAIRS4, src_dir=DATA, sp=sp)
    assert block_lines(render(blocks)) == expect("roast4.maf")


def test_tba_ref_centric():
    sp = sc.init_scores70()
    blocks = tba_run(TREE4, PAIRS4, src_dir=DATA, ref="human", sp=sp)
    assert block_lines(render(blocks)) == expect("tbaE.maf")


def test_tba_output_is_threaded():
    from multiz_jax.cli.maf_check_thread import check_threading
    from multiz_jax.maf_project import project

    sp = sc.init_scores70()
    blocks = tba_run(TREE3, PAIRS3, src_dir=DATA, sp=sp)
    for species in ("human", "chimp", "mouse"):
        proj, _ = project(
            [a.copy() for a in blocks], species, do_beautify=False, sp=sp
        )
        assert check_threading(proj) == [], f"not threaded for {species}"


def test_tba_multic_4species():
    """tba P=multic (tba.c:353-356 strstr dispatch; multic replaces multiz
    inside the same command strings, tba.c:17-18)."""
    sp = sc.init_scores70()
    blocks = tba_run(TREE4, PAIRS4, src_dir=DATA, sp=sp, aligner="multic")
    assert block_lines(render(blocks)) == expect("tbaP4.maf")


def test_roast_multic_4species():
    """roast P=multic (auto_mz.c:182-185)."""
    sp = sc.init_scores70()
    blocks = roast_run("human", TREE4, PAIRS4, src_dir=DATA, sp=sp,
                       aligner="multic")
    assert block_lines(render(blocks)) == expect("roastP4.maf")


def test_tba_parallel_schedule_deterministic():
    """Same-depth tree merges on a thread pool produce the identical
    block stream as the sequential schedule (SURVEY.md §2.5 last row)."""
    sp = sc.init_scores70()
    blocks = tba_run(TREE4, PAIRS4, src_dir=DATA, sp=sp, parallel=4)
    assert block_lines(render(blocks)) == expect("tba4.maf")


def test_plans_and_parallel_failure():
    """tba_plan/roast_plan cover every node; a raising merge in parallel
    mode propagates instead of deadlocking the pool."""
    from multiz_jax.tree import roast_plan, tba_plan

    plan = tba_plan(TREE4, PAIRS4, ref="human")
    assert sum(l.startswith("node ") for l in plan) == 3
    assert any("multiz" in l for l in plan)
    rplan = roast_plan("human", TREE4, PAIRS4)
    assert rplan[-1].startswith("final: maf_project")
    # missing pair files -> leaf merge raises; must not hang
    with pytest.raises(ValueError, match="no alignment found"):
        tba_run(TREE4, ["human.rat.sing.maf"], src_dir=DATA,
                sp=sc.init_scores70(), parallel=4)
