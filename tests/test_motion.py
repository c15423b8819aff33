"""Motion model tests: dead reckoning, noise decomposition, propagation."""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from montecarlolocalisation.config import MotionModelConfig
from montecarlolocalisation.models import motion

CFG = MotionModelConfig()
NOISE_FREE = MotionModelConfig(alpha_1=0, alpha_2=0, alpha_3=0, alpha_4=0)
TICK = CFG.wheel_size * 0.5  # encoder rad -> meters


def test_straight_line_integration():
    st = motion.OdometryState.zero()
    # 0.31 m on both wheels: enc = d / (wheel_size * 0.5).
    enc = 0.31 / TICK
    st2, rot1, trans, rot2 = motion.diff_drive_update(st, enc, enc, CFG)
    assert float(st2.x) == pytest.approx(0.31, rel=1e-5)
    assert float(st2.y) == pytest.approx(0.0, abs=1e-7)
    assert float(st2.theta) == pytest.approx(0.0, abs=1e-7)
    assert float(rot1) == pytest.approx(0.0, abs=1e-6)
    assert float(trans) == pytest.approx(0.31, rel=1e-5)
    assert float(rot2) == pytest.approx(0.0, abs=1e-6)


def test_pure_rotation():
    st = motion.OdometryState.zero()
    # d_left = -d_right -> in-place turn; delta_theta = (dL - dR)/wheel_space.
    d = 0.1
    st2, rot1, trans, rot2 = motion.diff_drive_update(
        st, d / TICK, -d / TICK, CFG)
    expect = (d - (-d)) / CFG.wheel_space
    assert float(st2.theta) == pytest.approx(expect, rel=1e-5)
    assert float(trans) == pytest.approx(0.0, abs=1e-7)
    # Degenerate-trans decomposition quirk: rot1 = atan2(0,0) - 0 = 0 here.
    assert float(rot1 + rot2) == pytest.approx(expect, rel=1e-5)


def test_midpoint_heading_arc():
    st = motion.OdometryState.zero()
    d_left, d_right = 0.2, 0.1
    st2, *_ = motion.diff_drive_update(st, d_left / TICK, d_right / TICK, CFG)
    d_center = 0.15
    dtheta = (d_left - d_right) / CFG.wheel_space
    assert float(st2.x) == pytest.approx(d_center * math.cos(dtheta / 2), rel=1e-5)
    assert float(st2.y) == pytest.approx(d_center * math.sin(dtheta / 2), rel=1e-5)


def test_noise_free_propagation_deterministic():
    key = jax.random.PRNGKey(0)
    parts = jnp.array([[1.0, 1.0, 0.0], [2.0, 2.0, math.pi / 2]])
    st = motion.OdometryState.zero()
    enc = 0.2 / TICK
    st2, moved = motion.motion_update(key, parts, st, enc, enc, NOISE_FREE)
    np.testing.assert_allclose(
        np.asarray(moved),
        [[1.2, 1.0, 0.0], [2.0, 2.2, math.pi / 2]], rtol=1e-5, atol=1e-6)


def test_shared_noise_is_identical_across_particles():
    key = jax.random.PRNGKey(1)
    parts = jnp.zeros((8, 3))
    st = motion.OdometryState.zero()
    enc = 0.3 / TICK
    _, moved = motion.motion_update(key, parts, st, enc, enc, CFG)
    # Shared noise: every particle gets the same delta (reference quirk,
    # monte_carlo.cpp:740-755).
    mv = np.asarray(moved)
    np.testing.assert_allclose(mv, np.tile(mv[0:1], (8, 1)), rtol=1e-6)


def test_per_particle_noise_differs():
    cfg = dataclasses.replace(CFG, shared_noise=False)
    key = jax.random.PRNGKey(1)
    parts = jnp.zeros((64, 3))
    st = motion.OdometryState.zero()
    enc = 0.3 / TICK
    _, moved = motion.motion_update(key, parts, st, enc, enc, cfg)
    assert np.asarray(moved)[:, 0].std() > 0


def test_noise_statistics():
    # Variance of sampled trans matches alpha_3*trans (+ alpha_4 rot terms).
    key = jax.random.PRNGKey(2)
    rot1, trans, rot2 = jnp.float32(0.0), jnp.float32(1.0), jnp.float32(0.0)
    _, n_trans, _ = motion.sample_motion_noise(
        key, rot1, trans, rot2, CFG, shape=(20000,))
    var = float(jnp.var(n_trans))
    assert var == pytest.approx(CFG.alpha_3 * 1.0, rel=0.1)


def test_encoder_state_advances():
    st = motion.OdometryState.zero()
    st2, *_ = motion.diff_drive_update(st, 5.0, 7.0, CFG)
    assert float(st2.encoder_left) == 5.0
    assert float(st2.encoder_right) == 7.0
    # Second tick with the same readings -> no motion.
    st3, rot1, trans, rot2 = motion.diff_drive_update(st2, 5.0, 7.0, CFG)
    assert float(trans) == 0.0
