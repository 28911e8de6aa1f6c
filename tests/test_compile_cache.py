"""Where the persistent XLA compile cache lands (multiz_jax/__init__.py):
JAX_COMPILATION_CACHE_DIR when it is set, else one fixed path inside the
checkout (.cache/jax, listed in .gitignore)."""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROBE = (
    "import sys; sys.path.insert(0, sys.argv[1]); import multiz_jax, jax; "
    "print(jax.config.jax_compilation_cache_dir)"
)


def _cache_dir(tmp_path, **env):
    base = {k: v for k, v in os.environ.items()
            if k not in ("JAX_COMPILATION_CACHE_DIR",
                         "MULTIZ_NO_COMPILE_CACHE")}
    out = subprocess.run(
        [sys.executable, "-c", PROBE, REPO], env={**base, **env},
        cwd=tmp_path, capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[-1]


def test_default_cache_inside_checkout(tmp_path):
    assert _cache_dir(tmp_path) == os.path.join(REPO, ".cache", "jax")
    with open(os.path.join(REPO, ".gitignore")) as fh:
        assert ".cache/" in fh.read().split()


@pytest.mark.parametrize("name", ["cacheA", "nested/cacheB"])
def test_explicit_cache_dir_wins(tmp_path, name):
    want = str(tmp_path / name)
    assert _cache_dir(tmp_path, JAX_COMPILATION_CACHE_DIR=want) == want
