"""Platform plumbing: the compile-cache location and the GPU smoke test's
refusal to run without a GPU."""

import os
import shutil
import subprocess
import sys

from conftest import REPO


def _run(code, env_extra=None, cwd=REPO):
    env = dict(os.environ)
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    env["JAX_PLATFORMS"] = "cpu"
    env.update(env_extra or {})
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


_PRINT_CACHE = (
    "from gpuspectral_tpu.utils.jaxcache import enable; enable(); "
    "import jax; print(jax.config.jax_compilation_cache_dir)")


def test_compile_cache_honours_env(tmp_path):
    p = _run(_PRINT_CACHE, {"JAX_COMPILATION_CACHE_DIR": str(tmp_path)})
    assert p.returncode == 0, p.stderr
    assert p.stdout.strip().splitlines()[-1] == str(tmp_path)


def test_compile_cache_defaults_to_checkout():
    p = _run(_PRINT_CACHE)
    assert p.returncode == 0, p.stderr
    assert p.stdout.strip().splitlines()[-1] == str(REPO / ".jax_cache")


_PRINT_FLAGS = "import os, gpuspectral_tpu; print(os.environ['XLA_FLAGS'])"


def test_import_adds_gpu_xla_flags():
    p = _run(_PRINT_FLAGS, {"XLA_FLAGS": "--xla_dump_to=/dev/null"})
    assert p.returncode == 0, p.stderr
    flags = p.stdout.strip().splitlines()[-1].split()
    assert flags[0] == "--xla_dump_to=/dev/null"
    assert "--xla_gpu_unsupported_enable_triton_multi_output_fusion=false" in flags
    assert "--xla_disable_hlo_passes=triton-softmax-rewriter" in flags


def test_import_keeps_users_xla_flags():
    mine = "--xla_disable_hlo_passes=fusion-merger"
    p = _run(_PRINT_FLAGS, {"XLA_FLAGS": mine})
    assert p.returncode == 0, p.stderr
    flags = p.stdout.strip().splitlines()[-1].split()
    assert flags[0] == mine
    assert [f for f in flags if "disable_hlo_passes" in f] == [mine]


def _last_line(p):
    lines = p.stdout.strip().splitlines()
    return lines[-1] if lines else ""


def test_chip_smoke_refuses_cpu_only_host():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    p = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert '"ok"' not in _last_line(p)


def test_chip_smoke_needs_the_repo(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    p = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert '"ok"' not in _last_line(p)
