"""Parity tests for the fused beam-weight kernel (ops/weights_pallas).

The kernel is a Pallas kernel for the Triton route; here it runs in the
Pallas interpreter on the CPU (`interpret=True`, the only way tests reach
it).  On the card, chip_smoke.py phase 2 compares the compiled kernel with
the dense path at 1M x 34.  Asserted here: the kernel matches the dense XLA
path for every configuration sensor.resolve_lookup_mode routes to it,
padding does not leak, vmap folds into the episode grid axis, and
unsupported configurations are refused.

The interpreter runs the grid as a Python loop, so shapes stay small.
"""
import os.path as osp

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from montecarlolocalisation.config import SensorModelConfig
from montecarlolocalisation.maps import from_map_file
from montecarlolocalisation.models import resample, sensor
from montecarlolocalisation.models.sensor import (
    _beam_weights_dense, beam_weights_fused,
)
from montecarlolocalisation.ops.weights_pallas import (
    BLOCK, beam_weights_kernel, supports,
)

MAP_PATH = osp.join(osp.dirname(__file__), "..", "montecarlolocalisation",
                    "maps", "default_map.txt")
ANALYTIC = SensorModelConfig(ray_mode="analytic")


def _fixture(n=256, beams=8, seed=0):
    m = from_map_file(MAP_PATH)
    angles = np.deg2rad(np.linspace(-118, 118, beams)).astype(np.float32)
    parts = resample.sample_uniform_particles(jax.random.PRNGKey(seed), m, n)
    scan = sensor.simulate_scan(m, jnp.array([1.25, 1.25, 0.0]), angles,
                                ANALYTIC)
    # Exercise the mask path: pad two dead lanes.
    scan = sensor.Scan(
        angles=jnp.pad(scan.angles, (0, 2)),
        ranges=jnp.pad(scan.ranges, (0, 2)),
        mask=jnp.pad(jnp.ones(beams, bool), (0, 2)),
    )
    return m, parts, scan


def _dense(m, parts, scan, cfg):
    return np.asarray(_beam_weights_dense(m, parts, scan, cfg,
                                          m.resolution, "gather"))


def _assert_close_but_ties(got, want, rtol=1e-5, atol=1e-5, frac=0.995):
    # Analytic casts can differ at pixel-boundary ties (the kernel's
    # angle-addition directions differ from cos(th + a) by ulps), which
    # shifts one beam's whole Gaussian; everything else agrees to ulps.
    close = np.isclose(got, want, rtol=rtol, atol=atol)
    assert close.mean() >= frac
    np.testing.assert_allclose(got[close], want[close], rtol=rtol, atol=atol)


@pytest.mark.parametrize("n", [256, 129, 1])
def test_kernel_matches_dense_sum(n):
    m, parts, scan = _fixture(n=n)
    got = np.asarray(beam_weights_fused(m, parts, scan, ANALYTIC,
                                        interpret=True))
    assert got.shape == (n,)
    _assert_close_but_ties(got, _dense(m, parts, scan, ANALYTIC))


@pytest.mark.parametrize("temperature", [1.0, 2.0])
def test_kernel_matches_dense_log(temperature):
    m, parts, scan = _fixture()
    cfg = SensorModelConfig(ray_mode="analytic", beam_combine="log",
                            log_temperature=temperature)
    got = np.asarray(beam_weights_fused(m, parts, scan, cfg,
                                        interpret=True))
    _assert_close_but_ties(got, _dense(m, parts, scan, cfg), rtol=1e-4,
                           atol=1e-6)


@pytest.mark.parametrize("cfg", [
    SensorModelConfig(ray_mode="dda"),
    SensorModelConfig(ray_mode="fixed"),
    SensorModelConfig(ray_mode="analytic", quantize_ray_deg=True),
], ids=["dda", "fixed", "quantized"])
def test_kernel_rejects_dda(cfg):
    m, parts, scan = _fixture(n=64)
    assert not supports(m, parts, cfg, m.resolution)
    with pytest.raises(ValueError):
        beam_weights_kernel(m, parts[None], scan.angles, scan.ranges[None],
                            scan.mask[None], cfg, interpret=True)


def test_kernel_pads_to_tile():
    # N not a multiple of BLOCK: padded lanes must not leak into the
    # result, nor into the log-mode max shift.
    n = BLOCK + 3
    m, parts, scan = _fixture(n=n)
    for combine in ("sum", "log"):
        cfg = SensorModelConfig(ray_mode="analytic", beam_combine=combine)
        raw = np.asarray(beam_weights_kernel(
            m, parts[None], scan.angles, scan.ranges[None],
            scan.mask[None].astype(jnp.float32), cfg, interpret=True))
        assert raw.shape == (1, n)
        got = np.asarray(beam_weights_fused(m, parts, scan, cfg,
                                            interpret=True))
        _assert_close_but_ties(got, _dense(m, parts, scan, cfg), rtol=1e-4,
                               atol=1e-6)


def _batch_fixture(n_ep=3, n=200, beams=8):
    m = from_map_file(MAP_PATH)
    angles = np.deg2rad(np.linspace(-118, 118, beams)).astype(np.float32)
    keys = jax.random.split(jax.random.PRNGKey(7), n_ep)
    parts = jnp.stack([
        resample.sample_uniform_particles(k, m, n) for k in keys])
    poses = jnp.array([[1.25, 1.25, 0.0], [2.1, 0.5, 1.2], [0.5, 3.3, -2.0]])
    ranges = jnp.stack([
        sensor.simulate_scan(m, poses[e % 3], angles, ANALYTIC).ranges
        for e in range(n_ep)])
    mask = jnp.ones((n_ep, beams), bool).at[1, 3].set(False)
    return m, parts, jnp.asarray(angles), ranges, mask


@pytest.mark.parametrize("combine", ["sum", "log"])
def test_batched_dispatch_under_vmap_matches_dense(combine):
    # vmap over episodes folds into the kernel's episode grid axis; each
    # episode (log mode: its own max shift) equals the dense path.
    m, parts, angles, ranges, mask = _batch_fixture()
    cfg = SensorModelConfig(ray_mode="analytic", beam_combine=combine)
    got = np.asarray(jax.vmap(lambda p, r, mk: beam_weights_fused(
        m, p, sensor.Scan(angles=angles, ranges=r, mask=mk), cfg,
        interpret=True))(parts, ranges, mask))
    want = np.asarray(jax.vmap(lambda p, r, mk: _beam_weights_dense(
        m, p, sensor.Scan(angles=angles, ranges=r, mask=mk), cfg,
        m.resolution, "gather"))(parts, ranges, mask))
    _assert_close_but_ties(got, want, rtol=1e-4, atol=1e-6)


def test_batched_kernel_nested_vmap_folds():
    # A second vmap level folds into the episode axis by reshape: the
    # result equals one flat launch over all episodes.
    m, parts, angles, ranges, mask = _batch_fixture(n_ep=2, n=130)
    p2 = jnp.stack([parts, parts + 0.01])          # [2, 2, N, 3]
    r2 = jnp.stack([ranges, ranges])

    def one(p, r, mk):
        return beam_weights_fused(
            m, p, sensor.Scan(angles=angles, ranges=r, mask=mk), ANALYTIC,
            interpret=True)

    got = jax.vmap(jax.vmap(one))(p2, r2, jnp.stack([mask, mask]))
    flat = beam_weights_kernel(
        m, p2.reshape(4, 130, 3), angles, r2.reshape(4, -1),
        jnp.stack([mask, mask]).reshape(4, -1).astype(jnp.float32),
        ANALYTIC, interpret=True)
    np.testing.assert_array_equal(np.asarray(got).reshape(4, 130),
                                  np.asarray(flat))


def test_per_episode_beam_table_takes_dense_path():
    # A batched beam table cannot share the kernel's beam block: the vmap
    # rule sends it to the dense path, bit-identical to a dense vmap.
    m, parts, angles, ranges, mask = _batch_fixture(n_ep=2, n=64)
    ang2 = jnp.stack([angles, angles * 0.5])
    got = jax.vmap(lambda p, a, r, mk: beam_weights_fused(
        m, p, sensor.Scan(angles=a, ranges=r, mask=mk), ANALYTIC,
        interpret=True))(parts, ang2, ranges, mask)
    want = jax.vmap(lambda p, a, r, mk: _beam_weights_dense(
        m, p, sensor.Scan(angles=a, ranges=r, mask=mk), ANALYTIC,
        m.resolution, "gather"))(parts, ang2, ranges, mask)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


@pytest.mark.parametrize("combine", ["sum", "log"])
def test_kernel_on_wide_map(combine):
    # Maps wider/taller than 64 raster px (> 7 cells) need multi-word bit
    # packing — regression for the W<=64 crash the map-family fuzz found.
    from montecarlolocalisation.maps import from_walls, generator

    m = from_walls(generator.generate_maze(9, 12, seed=4))
    angles = np.deg2rad(np.linspace(-118, 118, 8)).astype(np.float32)
    parts = resample.sample_uniform_particles(jax.random.PRNGKey(2), m, 256)
    scan = sensor.simulate_scan(m, jnp.array([2.0, 2.0, 0.3]), angles,
                                ANALYTIC)
    cfg = SensorModelConfig(ray_mode="analytic", beam_combine=combine)
    got = np.asarray(beam_weights_fused(m, parts, scan, cfg,
                                        interpret=True))
    # This wall-dense 9x12 maze has ~0.5% tie lanes (the cast itself
    # matches DDA to 1e-4 on this map in test_analytic's fuzz).
    _assert_close_but_ties(got, _dense(m, parts, scan, cfg), rtol=1e-4,
                           atol=1e-6, frac=0.99)


def test_fixed_kernel_nongridline_chain_march():
    """Non-gridline rasters have no analytic caster: the kernel refuses
    them, and "auto" keeps them on the dense path on every platform."""
    from montecarlolocalisation.maps import from_raster
    from montecarlolocalisation.ops.analytic import AnalyticCasterCache

    occ = np.zeros((33, 33), dtype=bool)
    occ[:, 0] = occ[:, -1] = occ[0, :] = occ[-1, :] = True
    occ[13, 4:28] = True   # off-lattice wall row
    occ[4:28, 21] = True   # off-lattice wall column
    m = from_raster(occ, resolution=0.1)
    assert AnalyticCasterCache.get(m) is None  # really non-gridline
    parts = resample.sample_uniform_particles(jax.random.PRNGKey(3), m, 64)
    assert not supports(m, parts, ANALYTIC, m.resolution)
    for platform in ("cpu", "gpu"):
        assert sensor.resolve_lookup_mode(m, parts, ANALYTIC, 0.1,
                                          platform) == "gather"
