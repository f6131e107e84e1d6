"""Where the program keeps its compile cache, and what chip_smoke.py does
on a machine without a GPU."""

import os
import shutil
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _env(**overrides):
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_COMPILATION_CACHE_DIR", "XLA_FLAGS")}
    env["JAX_PLATFORMS"] = "cpu"
    env.update(overrides)
    return env


@pytest.mark.parametrize("configured", [True, False])
def test_compile_cache_dir(tmp_path, configured):
    """JAX_COMPILATION_CACHE_DIR is honoured when set; otherwise the cache
    sits at the fixed .jax_cache path inside the checkout."""
    env = _env(JAX_COMPILATION_CACHE_DIR=str(tmp_path)) if configured else _env()
    out = subprocess.run(
        [sys.executable, "-c",
         "import jax, libsbn_tpu; print(jax.config.jax_compilation_cache_dir)"],
        capture_output=True, text=True, cwd=ROOT, env=env, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    want = str(tmp_path) if configured else os.path.join(ROOT, ".jax_cache")
    assert out.stdout.strip().splitlines()[-1] == want


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_gpu(tmp_path, alone):
    """chip_smoke.py exits nonzero and prints no result when JAX finds no
    GPU, in the checkout and in a directory holding the script alone."""
    cwd = ROOT
    if alone:
        shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
        cwd = str(tmp_path)
    out = subprocess.run(
        [sys.executable, "chip_smoke.py"], capture_output=True, text=True,
        cwd=cwd, env=_env(), timeout=300,
    )
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
