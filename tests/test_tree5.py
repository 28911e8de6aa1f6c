"""5-species, 2-chromosome pipeline goldens (block-stream equality).

Broadens the corpus past the 3/4-species single-chromosome set:
exercises the per-chromosome work split (seperate_cp_wk,
multi_util.c:816-843), multi-contig projection, deeper merge trees, and
the threaded schedule. Inputs were simulated (tests/sim.py
simulate_multi) and post-processed by the freshly built reference
binaries; expect files are raw reference outputs.
"""

import io
import os

import pytest

from multiz_jax import scores as sc
from multiz_jax.cli import single_cov2 as sc2_cli
from multiz_jax.maf import format_ali
from multiz_jax.tree import roast_run, tba_run

from .conftest import GOLDEN

DATA = os.path.join(GOLDEN, "data5")
EXPECT = os.path.join(GOLDEN, "expect")
SPECIES = ("chimp", "mouse", "rat", "dog")
PAIRS = [f"human.{s}.sing.maf" for s in SPECIES]
TREE = "((((human chimp) mouse) rat) dog)"


def block_lines(text: str):
    return [l for l in text.split("\n") if l and not l.startswith("#")]


def expect(name):
    with open(os.path.join(EXPECT, name)) as fh:
        return block_lines(fh.read())


def render(blocks):
    return "".join(format_ali(a) for a in blocks)


@pytest.mark.parametrize("species", SPECIES)
def test_single_cov2_multichrom(species):
    """Our single_cov2 reproduces the reference's .sing.maf for the
    2-chromosome pairwise inputs."""
    out = io.StringIO()
    sc2_cli.main([os.path.join(DATA, f"human.{species}.orig.maf")],
                 out=out)
    with open(os.path.join(DATA, f"human.{species}.sing.maf")) as fh:
        want = block_lines(fh.read())
    assert block_lines(out.getvalue()) == want


def test_tba_5species_multichrom():
    sp = sc.init_scores70()
    blocks = tba_run(TREE, PAIRS, src_dir=DATA, sp=sp)
    assert block_lines(render(blocks)) == expect("tba5.maf")


def test_tba_5species_parallel():
    sp = sc.init_scores70()
    blocks = tba_run(TREE, PAIRS, src_dir=DATA, sp=sp, parallel=4)
    assert block_lines(render(blocks)) == expect("tba5.maf")


def test_tba_5species_parallel_shared_batch():
    """Concurrent merges pooling DP jobs into shared batches
    (tree.SharedBatch) are byte-identical to the sequential scan."""
    from multiz_jax.multiz import MultizConfig
    from multiz_jax.ops.dispatch import host_batch

    sp = sc.init_scores70()
    blocks = tba_run(
        TREE, PAIRS, src_dir=DATA, sp=sp, parallel=4,
        cfg=MultizConfig(batch_fn=host_batch),
    )
    assert block_lines(render(blocks)) == expect("tba5.maf")


def test_roast_5species_multichrom():
    sp = sc.init_scores70()
    blocks = roast_run("human", TREE, PAIRS, src_dir=DATA, sp=sp)
    assert block_lines(render(blocks)) == expect("roast5.maf")
