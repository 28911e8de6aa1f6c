"""multiz_jax — a multiple-genome aligner with multiz/TBA capabilities.

A from-scratch JAX/XLA/CUDA re-design of the multiz/TBA toolkit
(Blanchette et al. 2004): progressive "align two alignments" multiple
alignment over a phylogenetic guide tree, with the banded column DP executed
as batched device kernels and the MAF algebra as a vectorized host layer.
"""

__version__ = "0.1.0"

import os as _os

# Persistent XLA compilation cache, so that later processes (tests,
# bench, pipelines) start with every bucket shape compiled. An explicit
# JAX_COMPILATION_CACHE_DIR wins; otherwise the cache lives at one fixed
# path inside the checkout (.cache/jax, listed in .gitignore). Opt out
# with MULTIZ_NO_COMPILE_CACHE=1.
if not _os.environ.get("MULTIZ_NO_COMPILE_CACHE"):
    _os.environ.setdefault(
        "JAX_COMPILATION_CACHE_DIR",
        _os.path.join(
            _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
            ".cache", "jax",
        ),
    )
    # cache every program, even fast-compiling ones
    _os.environ.setdefault(
        "JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS", "0.2"
    )
    _os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_ENTRY_SIZE_BYTES", "0")

    import sys as _sys

    if "jax" in _sys.modules:  # env was read already; set via config
        import jax as _jax

        _jax.config.update(
            "jax_compilation_cache_dir",
            _os.environ["JAX_COMPILATION_CACHE_DIR"],
        )
        _jax.config.update(
            "jax_persistent_cache_min_compile_time_secs",
            float(_os.environ["JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS"]),
        )
        _jax.config.update(
            "jax_persistent_cache_min_entry_size_bytes",
            int(_os.environ["JAX_PERSISTENT_CACHE_MIN_ENTRY_SIZE_BYTES"]),
        )
