"""Ray caster tests: fixed-step reference semantics vs exact DDA."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from montecarlolocalisation.config import SensorModelConfig
from montecarlolocalisation.maps import from_walls
from montecarlolocalisation.models.raycast import raycast

# Single closed cell: walls all around. Raster 9x9; right wall pixels at
# x in [0.8, 0.9), bottom at y in [0.8, 0.9), top row y in [0, 0.1),
# left col x in [0, 0.1).
BOX = from_walls([[[0, 1, 2, 3]]])

FIXED = SensorModelConfig(ray_mode="fixed")
DDA = SensorModelConfig(ray_mode="dda")


def test_fixed_step_quantizes_up():
    # From (0.45, 0.45) heading +x: wall pixel starts at x=0.8 -> true
    # distance 0.35; fixed 0.1-stepping first samples inside at r=0.4
    # (monte_carlo.cpp:370-372 semantics).
    d = raycast(BOX, 0.45, 0.45, 0.0, FIXED)
    assert float(d) == pytest.approx(0.4)


def test_dda_exact():
    d = raycast(BOX, 0.45, 0.45, 0.0, DDA)
    assert float(d) == pytest.approx(0.35, abs=1e-5)
    d = raycast(BOX, 0.45, 0.45, jnp.pi, DDA)
    assert float(d) == pytest.approx(0.35, abs=1e-5)  # left wall ends x=0.1
    d = raycast(BOX, 0.45, 0.45, jnp.pi / 2, DDA)
    assert float(d) == pytest.approx(0.35, abs=1e-5)


def test_diagonal_dda():
    # 45 degrees from (0.45, 0.45): first wall-pixel entry at x=y=0.8,
    # t = 0.35 * sqrt(2).
    d = raycast(BOX, 0.45, 0.45, jnp.pi / 4, DDA)
    assert float(d) == pytest.approx(0.35 * np.sqrt(2.0), abs=1e-5)


def test_no_hit_returns_max_range():
    big = from_walls([[[1, 2], [1]], [[2], []]])  # mostly open 2x2
    d = raycast(big, 0.45, 0.45, 0.0, SensorModelConfig(ray_mode="dda"))
    # heading +x from cell (0,0): no wall between cells or on the right
    # within 1.0 m (right boundary of the 2x2 map is open except last-col
    # rule, which only draws when the cell lists R).
    assert float(d) == pytest.approx(1.0)


def test_origin_inside_wall_is_zero():
    d_f = raycast(BOX, 0.05, 0.45, 0.0, FIXED)
    d_d = raycast(BOX, 0.05, 0.45, 0.0, DDA)
    assert float(d_f) == 0.0
    assert float(d_d) == 0.0


def test_out_of_map_returns_max_range():
    for cfg in (FIXED, DDA):
        d = raycast(BOX, -0.5, 0.45, jnp.pi, cfg)
        assert float(d) == pytest.approx(1.0)


def test_batched_shapes():
    ox = jnp.full((5,), 0.45)
    oy = jnp.full((5,), 0.45)
    ang = jnp.linspace(0, 2 * jnp.pi, 5)
    for cfg in (FIXED, DDA):
        d = raycast(BOX, ox, oy, ang, cfg)
        assert d.shape == (5,)
        assert (np.asarray(d) <= 1.0).all() and (np.asarray(d) >= 0.0).all()


def test_fixed_vs_dda_agreement():
    # Fixed-step hits are always within one step above the exact distance.
    rng = np.random.default_rng(0)
    ox = jnp.asarray(rng.uniform(0.15, 0.65, 64), jnp.float32)
    oy = jnp.asarray(rng.uniform(0.15, 0.65, 64), jnp.float32)
    ang = jnp.asarray(rng.uniform(-np.pi, np.pi, 64), jnp.float32)
    df = np.asarray(raycast(BOX, ox, oy, ang, FIXED))
    dd = np.asarray(raycast(BOX, ox, oy, ang, DDA))
    hit = df < 1.0
    assert (df[hit] >= dd[hit] - 1e-5).all()
    assert (df[hit] - dd[hit] <= 0.1 + 1e-5).all()


def test_quantized_mode_matches_1deg():
    cfg = dataclasses.replace(DDA, quantize_ray_deg=True)
    a = jnp.float32(np.deg2rad(30.4))
    d_q = raycast(BOX, 0.45, 0.45, a, cfg)
    d_30 = raycast(BOX, 0.45, 0.45, jnp.float32(np.deg2rad(30.0)), DDA)
    assert float(d_q) == pytest.approx(float(d_30), abs=1e-5)
