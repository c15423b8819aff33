"""One backend policy for every platform, the compile-cache location, and
chip_smoke.py's behaviour off the card."""
import os
import os.path as osp
import re
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from montecarlolocalisation.config import (InitConfig, ResampleConfig,
                                           SensorModelConfig)
from montecarlolocalisation.maps import from_map_file
from montecarlolocalisation.models import raycast, sensor
from montecarlolocalisation.utils import compile_cache

ROOT = osp.abspath(osp.join(osp.dirname(__file__), ".."))
PKG = osp.join(ROOT, "montecarlolocalisation")


@pytest.fixture(scope="module")
def maze():
    return from_map_file(osp.join(PKG, "maps", "default_map.txt"))


@pytest.mark.parametrize("platform", ["cpu", "gpu", "rocm"])
@pytest.mark.parametrize("ray_mode", ["analytic", "fixed", "dda"])
def test_auto_lookup_mode_resolution(maze, platform, ray_mode):
    """"auto" is the dense gather path everywhere except the one measured
    exception: the fused kernel for the analytic caster on the GPU."""
    parts = jnp.zeros((16, 3))
    cfg = SensorModelConfig(ray_mode=ray_mode)
    want = ("pallas" if platform == "gpu" and ray_mode == "analytic"
            else "gather")
    assert sensor.resolve_lookup_mode(maze, parts, cfg, 0.1,
                                      platform) == want
    # Per-lookup callers (ray casts outside the weight stage) never
    # depend on the platform.
    assert raycast._lookup_mode(cfg, maze) == "gather"


def test_pallas_request_off_the_gpu_raises(maze):
    cfg = SensorModelConfig(ray_mode="analytic", lookup_mode="pallas")
    scan = sensor.make_scan(np.zeros(4, np.float32), np.ones(4, np.float32))
    with pytest.raises(ValueError, match="needs a GPU"):
        sensor.beam_weights(maze, jnp.zeros((8, 3)), scan, cfg)


def test_defaults_and_no_platform_branches():
    assert ResampleConfig().multinomial_impl == "exact"
    assert InitConfig().sampler == "reference"
    # The backend is chosen in exactly one function, and the only Pallas
    # route imported is Triton.
    hits, routes = [], set()
    for dirpath, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                src = open(osp.join(dirpath, f)).read()
                if re.search(r"default_backend\(\)", src):
                    hits.append(osp.relpath(osp.join(dirpath, f), PKG))
                routes |= set(re.findall(
                    r"from jax\.experimental\.pallas import (\w+)", src))
                routes |= set(re.findall(
                    r"jax\.experimental\.pallas\.(\w+)", src))
    assert hits == [osp.join("models", "sensor.py")]
    assert routes == {"triton"}


# -- compile cache ----------------------------------------------------------
@pytest.fixture
def restore_cache_dir():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_compile_cache_honours_env(monkeypatch, restore_cache_dir):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv(compile_cache.ENV, "/some/shared/cache")
    assert compile_cache.configure_compile_cache() == "/some/shared/cache"
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_default_is_checkout(monkeypatch, tmp_path,
                                           restore_cache_dir):
    monkeypatch.delenv(compile_cache.ENV, raising=False)
    got = compile_cache.configure_compile_cache(str(tmp_path))
    assert got == str(tmp_path / ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == got


def test_compile_cache_path_is_fixed():
    # Part of the cache key: the same on every call, under the checkout.
    a = compile_cache.default_cache_dir()
    assert a == compile_cache.default_cache_dir()
    assert a == osp.join(ROOT, ".jax_cache")


# -- chip_smoke.py off the card ---------------------------------------------
def _run(args, cwd, timeout):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=timeout)


def test_chip_smoke_rehearse():
    r = _run([osp.join(ROOT, "chip_smoke.py"), "--rehearse"], ROOT, 900)
    assert r.returncode == 0, r.stderr[-3000:]
    lines = r.stdout.strip().splitlines()
    assert lines[-1].startswith("rehearsal complete")
    assert '"ok"' not in r.stdout
    for phase in ("phase2 analytic/sum", "phase2 fixed/log", "phase3a",
                  "phase3b", "phase3c", "phase3d", "phase3e", "phase3f"):
        assert any(ln.startswith(phase) for ln in lines), phase


def test_chip_smoke_fails_without_gpu():
    r = _run([osp.join(ROOT, "chip_smoke.py")], ROOT, 300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(osp.join(ROOT, "chip_smoke.py"), tmp_path)
    r = _run(["chip_smoke.py"], str(tmp_path), 300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
