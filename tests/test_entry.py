"""Entry-point plumbing: the compile cache location and chip_smoke.py's
refusal to run without a GPU."""

import os
import shutil
import subprocess
import sys

import jax

from caitlyn.utils import compile_cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_compile_cache_left_to_jax_when_env_names_one(monkeypatch):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setattr(jax.config, "update", lambda *a: (_ for _ in ()).throw(
        AssertionError("configured despite JAX_COMPILATION_CACHE_DIR")))
    env = {"JAX_COMPILATION_CACHE_DIR": "/some/where"}
    assert compile_cache.cache_dir(env) is None
    assert compile_cache.configure(env) == "/some/where"
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_defaults_inside_checkout(monkeypatch):
    calls = []
    monkeypatch.setattr(jax.config, "update", lambda k, v: calls.append((k, v)))
    path = compile_cache.configure({})
    assert path == os.path.join(REPO, ".jax_cache")
    assert calls == [("jax_compilation_cache_dir", path)]
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split(), ".jax_cache must be git-ignored"


def _run_smoke(cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    return subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=300,
    )


def test_chip_smoke_refuses_cpu():
    out = _run_smoke(REPO)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_chip_smoke_fails_without_the_program(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    out = _run_smoke(str(tmp_path))
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
