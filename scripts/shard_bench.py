"""Per-chromosome sharded tba wall-time measurement (config 4).

Runs tba_run_sharded over the staged bench_pipeline dataset and prints
wall time incl. shard staging. Usage:
  MZ_PIPE_REFLEN=20000000 MZ_PIPE_SPECIES=5 MZ_PIPE_CONTIGS=2 \
      python scripts/shard_bench.py [nshards]
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    import bench_pipeline as bp

    bp.build_dataset()
    from multiz_jax import scores as sc
    from multiz_jax.multiz import MultizConfig
    from multiz_jax.parallel.pipeline import tba_run_sharded

    nshards = int(sys.argv[1]) if len(sys.argv) > 1 else 2
    sp = sc.init_scores70()
    pairs = [f"human.{s}.sing.maf" for s in bp.SPECIES]
    t0 = time.perf_counter()
    blocks = tba_run_sharded(
        bp.TREE, pairs, src_dir=bp.CACHE, cfg=MultizConfig(),
        nshards=nshards, sp=sp,
    )
    dt = time.perf_counter() - t0
    print(
        f"sharded nshards={nshards}: {dt:.1f}s blocks={len(blocks)} "
        f"(incl. staging)"
    )


if __name__ == "__main__":
    main()
