"""Pipeline benchmark: end-to-end TBA (BASELINE configs 3-5).

Simulates an N-species dataset (human + N-1 diverged species,
~REF_LEN bases of reference over MZ_PIPE_CONTIGS chromosomes), runs
single_cov2 to produce .sing.maf inputs, then times the full in-memory
tba pipeline (tree merges, projections, threading) with the DP
executed (a) inline on host (the reference's shape), (b) as batched
device launches through the CUDA kernel, and (c) packed with
concurrent tree merges pooling their DP jobs into shared device
batches (tba_run(parallel=N) + SharedBatch, tree.py).

Knobs (env):
  MZ_PIPE_REFLEN   reference bases (default 200000; config 4 = tens of Mb)
  MZ_PIPE_SPECIES  total species incl. human (default 4; config 4 = 5,
                   config 5 = 12)
  MZ_PIPE_CONTIGS  chromosomes per species (default 1; config 4 = 2)
  MZ_PIPE_PAR      merge threads for the packed-par mode (default 4)

Prints one JSON line per mode:
  {"metric": "tba_refbases_per_sec", "mode": ..., "value": ...}
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

REF_LEN = int(os.environ.get("MZ_PIPE_REFLEN", "200000"))
N_SPECIES = int(os.environ.get("MZ_PIPE_SPECIES", "4"))
N_CONTIGS = int(os.environ.get("MZ_PIPE_CONTIGS", "1"))
PAR = int(os.environ.get("MZ_PIPE_PAR", "4"))

# name pool for the non-reference species, diverging progressively
# (config 5's 12-species shape uses the whole pool)
_POOL = (
    "chimp", "gorilla", "orang", "baboon", "marmoset", "mouse", "rat",
    "rabbit", "cow", "dog", "armadillo", "opossum", "platypus",
)
SPECIES = _POOL[: N_SPECIES - 1]
_DIV = tuple(
    round(0.02 + i * (0.30 - 0.02) / max(len(SPECIES) - 1, 1), 3)
    for i in range(len(SPECIES))
)


def _caterpillar_tree() -> str:
    t = "human"
    for s in SPECIES:
        t = f"({t} {s})"
    return t


TREE = _caterpillar_tree()
_tag = f"{REF_LEN}_{N_SPECIES}sp_{N_CONTIGS}c"
CACHE = os.environ.get(
    "MZ_PIPE_DIR",
    os.path.join(os.path.dirname(os.path.abspath(__file__)), ".cache",
                 f"pipebench_{_tag}"),
)


def build_dataset():
    sys.path.insert(
        0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests")
    )
    from sim import SimConfig, simulate, simulate_multi

    from multiz_jax.cli import single_cov2 as sc2_cli

    if os.path.exists(os.path.join(CACHE, f"human.{SPECIES[-1]}.sing.maf")):
        return
    cfg = SimConfig(
        seed=9, ref_len=REF_LEN, species=SPECIES, divergence=_DIV
    )
    t0 = time.perf_counter()
    if N_CONTIGS > 1:
        simulate_multi(cfg, CACHE, n_contigs=N_CONTIGS)
    else:
        simulate(cfg, CACHE)
    for s in SPECIES:
        with open(os.path.join(CACHE, f"human.{s}.sing.maf"), "w") as fh:
            sc2_cli.main(
                [os.path.join(CACHE, f"human.{s}.orig.maf")], out=fh
            )
    print(
        f"# dataset {_tag} built in {time.perf_counter() - t0:.1f}s",
        file=sys.stderr,
    )


def run(mode: str):
    from multiz_jax import scores as sc
    from multiz_jax.multiz import MultizConfig
    from multiz_jax.tree import tba_run

    sp = sc.init_scores70()
    batch_fn = None
    parallel = None
    if mode.startswith("packed"):
        from multiz_jax.ops.yama_pack import yama_batch_packed

        batch_fn = yama_batch_packed
        if mode == "packed-par":
            parallel = PAR
    elif mode == "host-batched":
        from multiz_jax.ops.dispatch import host_batch

        batch_fn = host_batch
    cfg = MultizConfig(batch_fn=batch_fn)
    pairs = [f"human.{s}.sing.maf" for s in SPECIES]
    t0 = time.perf_counter()
    blocks = tba_run(
        TREE, pairs, src_dir=CACHE, cfg=cfg, sp=sp, parallel=parallel
    )
    dt = time.perf_counter() - t0
    return blocks, dt


def main():
    build_dataset()
    modes = sys.argv[1:] or ["inline", "packed", "packed-par"]
    base = None
    for mode in modes:
        # two runs: the first pays per-bucket kernel compiles (the
        # persistent compile cache usually absorbs this after round 1)
        best = None
        for it in range(2 if mode != "inline" else 1):
            blocks, dt = run(mode)
            best = dt if best is None else min(best, dt)
        from multiz_jax.maf import format_ali

        rendered = "".join(format_ali(a) for a in blocks)
        if base is None:
            base = rendered
        else:
            # full rendered-block byte equality across modes (rows,
            # texts, scores — not just counts/starts)
            assert rendered == base, f"mode {mode} output differs!"
        print(
            json.dumps(
                {
                    "metric": "tba_refbases_per_sec",
                    "mode": mode,
                    "config": _tag,
                    "value": round(REF_LEN / best, 1),
                    "blocks": len(blocks),
                    "seconds": round(best, 2),
                }
            ),
            flush=True,
        )


if __name__ == "__main__":
    main()
