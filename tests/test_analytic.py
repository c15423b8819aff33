"""Analytic slab ray caster: exact equivalence with the DDA traversal."""
import os.path as osp

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from montecarlolocalisation.config import FilterConfig, SensorModelConfig
from montecarlolocalisation.maps import from_map_file, from_walls
from montecarlolocalisation.models.raycast import raycast

MAP_PATH = osp.join(osp.dirname(__file__), "..", "montecarlolocalisation",
                    "maps", "default_map.txt")

DDA = SensorModelConfig(ray_mode="dda", lookup_mode="gather")
ANA = SensorModelConfig(ray_mode="analytic")


def _compare(m, n=20000, seed=0, extent_pad=0.2):
    rng = np.random.default_rng(seed)
    ex, ey = float(m.extent_x), float(m.extent_y)
    ox = jnp.asarray(rng.uniform(-extent_pad, ex + extent_pad, n), jnp.float32)
    oy = jnp.asarray(rng.uniform(-extent_pad, ey + extent_pad, n), jnp.float32)
    ang = jnp.asarray(rng.uniform(-np.pi, np.pi, n), jnp.float32)
    dda = np.asarray(raycast(m, ox, oy, ang, DDA))
    ana = np.asarray(raycast(m, ox, oy, ang, ANA))
    return np.abs(dda - ana)


def test_exact_equivalence_default_map():
    m = from_map_file(MAP_PATH)
    diff = _compare(m)
    assert diff.max() <= 1e-4, f"max diff {diff.max()}"


def test_exact_equivalence_box():
    m = from_walls([[[0, 1, 2, 3]]])
    diff = _compare(m)
    assert diff.max() <= 1e-4


def test_exact_equivalence_generated_maze():
    from montecarlolocalisation.maps import generator

    m = from_walls(generator.generate_maze(5, 7, seed=3))
    diff = _compare(m)
    assert diff.max() <= 1e-4


def test_axis_aligned_and_degenerate_rays():
    m = from_walls([[[0, 1, 2, 3]]])
    # Pure +x, -x, +y, -y and exactly-on-gridline origins.
    ox = jnp.asarray([0.45, 0.45, 0.45, 0.45, 0.8, 0.1], jnp.float32)
    oy = jnp.asarray([0.45, 0.45, 0.45, 0.45, 0.45, 0.45], jnp.float32)
    ang = jnp.asarray([0.0, np.pi, np.pi / 2, -np.pi / 2, np.pi, 0.0],
                      jnp.float32)
    dda = np.asarray(raycast(m, ox, oy, ang, DDA))
    ana = np.asarray(raycast(m, ox, oy, ang, ANA))
    np.testing.assert_allclose(ana, dda, atol=1e-4)


def test_ragged_map_falls_back_to_dda():
    m = from_walls([[[1], [1]], [[1]]])  # ragged: pads off-grid pixels
    diff = _compare(m, n=5000)
    assert diff.max() <= 1e-4  # fallback = DDA itself


def test_beam_weights_with_analytic_mode():
    from montecarlolocalisation.models import resample, sensor

    m = from_map_file(MAP_PATH)
    angles = np.deg2rad(np.linspace(-118, 118, 16)).astype(np.float32)
    parts = resample.sample_uniform_particles(jax.random.PRNGKey(0), m, 512)
    scan = sensor.simulate_scan(m, jnp.array([2.05, 2.05, 0.3]), angles, DDA)
    w_dda = np.asarray(sensor.beam_weights(m, parts, scan, DDA))
    w_ana = np.asarray(sensor.beam_weights(
        m, parts, scan, SensorModelConfig(ray_mode="analytic")))
    np.testing.assert_allclose(w_ana, w_dda, rtol=1e-4, atol=1e-4)


def test_long_max_range_covers_all_slabs():
    """Regression: the candidate-slab count must scale with max_range
    (a hard-coded 3 misses hits beyond ~1.6 m)."""
    m = from_map_file(MAP_PATH)
    cfg_d = SensorModelConfig(ray_mode="dda", lookup_mode="gather",
                              max_range=3.0)
    cfg_a = SensorModelConfig(ray_mode="analytic", max_range=3.0)
    rng = np.random.default_rng(5)
    n = 4000
    ox = jnp.asarray(rng.uniform(0.0, 4.9, n), jnp.float32)
    oy = jnp.asarray(rng.uniform(0.0, 4.9, n), jnp.float32)
    ang = jnp.asarray(rng.uniform(-np.pi, np.pi, n), jnp.float32)
    dda = np.asarray(raycast(m, ox, oy, ang, cfg_d))
    ana = np.asarray(raycast(m, ox, oy, ang, cfg_a))
    assert np.abs(dda - ana).max() <= 1e-3, np.abs(dda - ana).max()


def test_fixed_mode_out_of_map_origin_matches_reference():
    """Regression: the fixed march must break at the first out-of-map
    sample (reference worldToMap failure), like dda/analytic."""
    m = from_map_file(MAP_PATH)
    for cfg in (SensorModelConfig(ray_mode="fixed", lookup_mode="gather"),
                SensorModelConfig(ray_mode="fixed", lookup_mode="bits")):
        d = raycast(m, jnp.float32(-0.5), jnp.float32(2.45),
                    jnp.float32(0.0), cfg)
        assert float(d) == 1.0, (cfg.lookup_mode, float(d))


def test_first_bit_pos_exhaustive_patterns():
    # Directional bit scan vs numpy, over adversarial 64-bit patterns:
    # single bits at every position, runs, the INT_MIN boundary, and the
    # rounding-overshoot values (0x7fffffff family).
    from montecarlolocalisation.ops.analytic import _first_bit_pos

    vals = [1 << i for i in range(64)]
    vals += [(1 << i) | (1 << j) for i in range(0, 64, 7)
             for j in range(0, 64, 11) if i != j]
    vals += [0x7FFFFFFF, 0xFFFFFFFF, 0x80000001, 0xFFFFFFFE,
             (0x7FFFFFFF << 32) | 0x1, (0xFFFFFFFF << 32) | 0xFFFFFFFF,
             0x80000000, 0x100000000]
    vals += [1 << 64, (1 << 95) | (1 << 3), (1 << 70) | (1 << 65)]
    words = [jnp.asarray([(v >> (32 * j)) & 0xFFFFFFFF for v in vals],
                         jnp.uint32) for j in range(3)]
    for forward in (True, False):
        fwd = jnp.full((len(vals),), forward)
        got = np.asarray(_first_bit_pos(words, fwd))
        for i, v in enumerate(vals):
            want = (v & -v).bit_length() - 1 if forward \
                else v.bit_length() - 1
            assert got[i] == want, (hex(v), forward, got[i], want)


def test_exact_equivalence_fuzz_random_maps():
    # Fuzz across map FAMILIES x sizes x seeds: perfect mazes, loopy
    # mazes, BSP rooms — all gridline-structured, all must match DDA to
    # pixel-tie tolerance on random rays (incl. out-of-map origins).
    from montecarlolocalisation.maps import generator

    cases = [
        generator.generate_maze(3, 3, seed=11),
        generator.generate_maze(8, 4, seed=12, extra_openings=6),
        generator.generate_maze(6, 6, seed=13, extra_openings=2),
        generator.generate_maze(12, 10, seed=16),   # > 64-px raster both axes
        generator.generate_rooms(6, 6, seed=14),
        generator.generate_rooms(4, 9, seed=15),    # wide: 73-px rows
    ]
    for i, walls in enumerate(cases):
        m = from_walls(walls)
        diff = _compare(m, n=8000, seed=100 + i)
        assert diff.max() <= 1e-4, f"case {i}: max diff {diff.max()}"


def test_wide_span_falls_back_to_mask_path():
    """max_range 5 m -> band span > 32 bits: the window strategy must
    route to the mask path per call and still match DDA."""
    m = from_map_file(MAP_PATH)
    cfg_d = SensorModelConfig(ray_mode="dda", lookup_mode="gather",
                              max_range=5.0)
    cfg_a = SensorModelConfig(ray_mode="analytic", max_range=5.0)
    rng = np.random.default_rng(9)
    n = 4000
    ox = jnp.asarray(rng.uniform(0.0, 4.9, n), jnp.float32)
    oy = jnp.asarray(rng.uniform(0.0, 4.9, n), jnp.float32)
    ang = jnp.asarray(rng.uniform(-np.pi, np.pi, n), jnp.float32)
    dda = np.asarray(raycast(m, ox, oy, ang, cfg_d))
    ana = np.asarray(raycast(m, ox, oy, ang, cfg_a))
    assert np.abs(dda - ana).max() <= 1e-3, np.abs(dda - ana).max()
