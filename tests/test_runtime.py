"""Run-time set-up: the compile cache location and chip_smoke.py's refusal
to run without a GPU."""

import os
import shutil
import subprocess
import sys

import jax

from cugp_tpu import runtime

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_compile_cache_defaults_to_checkout_dir(monkeypatch):
    monkeypatch.setattr(jax.config, "update", lambda *a: calls.append(a))
    calls = []
    path = runtime.configure_compile_cache({})
    assert path == os.path.join(REPO, ".jax_cache")
    assert calls == [("jax_compilation_cache_dir", path)]


def test_compile_cache_env_var_wins(monkeypatch, tmp_path):
    monkeypatch.setattr(jax.config, "update", lambda *a: calls.append(a))
    calls = []
    path = runtime.configure_compile_cache({runtime.CACHE_ENV: str(tmp_path)})
    assert path == str(tmp_path)
    assert calls == []  # JAX reads the variable itself


def _smoke(cwd, script):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, script], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_chip_smoke_refuses_the_cpu():
    out = _smoke(REPO, os.path.join(REPO, "chip_smoke.py"))
    assert out.returncode != 0
    assert "no GPU" in out.stderr
    assert '"ok"' not in out.stdout


def test_chip_smoke_alone_fails(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    out = _smoke(str(tmp_path), str(tmp_path / "chip_smoke.py"))
    assert out.returncode != 0
    assert "cugp_tpu not found" in out.stderr
    assert '"ok"' not in out.stdout
