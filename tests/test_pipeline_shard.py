"""Per-chromosome sharded tba (parallel/pipeline.py) vs single-process.

Equality contract (see the module docstring of parallel/pipeline.py):
block-multiset identity of the raw gathered blockset, and byte identity
after maf_project onto the reference — the canonical form the reference
workflow consumes (README2's per-species projection step).
"""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from sim import SimConfig, simulate_multi  # noqa: E402

from multiz_jax import scores as sc  # noqa: E402
from multiz_jax.maf import format_ali  # noqa: E402
from multiz_jax.multiz import MultizConfig  # noqa: E402
from multiz_jax.parallel.pipeline import (  # noqa: E402
    discover_contigs,
    make_shards,
    tba_run_sharded,
)
from multiz_jax.tree import t_project, tba_run  # noqa: E402


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("shard_data"))
    cfg = SimConfig(
        seed=11, ref_len=40_000, species=("chimp", "mouse"),
        divergence=(0.03, 0.2),
    )
    simulate_multi(cfg, d, n_contigs=2)
    from multiz_jax.cli import single_cov2 as sc2_cli

    for s in cfg.species:
        with open(os.path.join(d, f"human.{s}.sing.maf"), "w") as fh:
            sc2_cli.main([os.path.join(d, f"human.{s}.orig.maf")], out=fh)
    return d


def _render(blocks):
    return "".join(format_ali(a) for a in blocks)


def test_sharded_tba_matches_single_process(dataset):
    tree = "((human chimp) mouse)"
    pairs = ["human.chimp.sing.maf", "human.mouse.sing.maf"]
    sp = sc.init_scores70()
    cfg = MultizConfig()

    single = tba_run(tree, pairs, src_dir=dataset, cfg=cfg, sp=sp)
    sharded = tba_run_sharded(
        tree, pairs, src_dir=dataset, cfg=cfg, nshards=2, sp=sp
    )

    # 1) the gathered blockset is the same set of blocks
    a = sorted(format_ali(x) for x in single)
    b = sorted(format_ali(x) for x in sharded)
    assert a == b

    # 2) projected onto the reference, byte-identical per contig (the
    # reference's per-chromosome workflow emits one file per
    # chromosome; the cross-contig concatenation order of raw tba
    # output is a non-semantic artifact of each node's concat order,
    # tba.c:242-243)
    pa, _ = t_project(
        [x.copy_shared() for x in single], "human", with_others=True, sp=sp
    )
    pb, _ = t_project(
        [x.copy_shared() for x in sharded], "human", with_others=True, sp=sp
    )

    def by_contig(blocks):
        out = {}
        for x in blocks:
            out.setdefault(x.comps[0].src, []).append(x)
        return {k: _render(v) for k, v in out.items()}

    da, db = by_contig(pa), by_contig(pb)
    assert da.keys() == db.keys()
    for k in da:
        assert da[k] == db[k], f"projected contig {k} differs"


def test_shard_partition_is_total_and_disjoint(dataset):
    pairs = ["human.chimp.sing.maf", "human.mouse.sing.maf"]
    contigs = discover_contigs(pairs, dataset)
    assert contigs == sorted(contigs) and len(contigs) == 2
    shards = make_shards(contigs, 2)
    flat = [c for s in shards for c in s]
    assert sorted(flat) == contigs
