"""Differentiable calibration tests: recover known sim parameters from logs.

Ground truth comes from the simulator, which integrates the SAME
kinematics with known constants — so a correct fit must pull perturbed
initial guesses back to the generating values.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from montecarlolocalisation.config import (FilterConfig,
                                               MotionModelConfig,
                                               SensorModelConfig)
from montecarlolocalisation.models import calibrate, sensor
from montecarlolocalisation.sim import robot
import pytest


def _episode(m, cfg, ticks=200, seed=0, start=(2.05, 2.05, 0.0)):
    angles = np.deg2rad(np.linspace(-118, 118, 24)).astype(np.float32)
    enc, ranges, poses = robot.generate_wander_episode(
        jax.random.PRNGKey(seed), m, cfg, angles, ticks, start_pose=start)
    return angles, enc, ranges, poses


def test_integrate_odometry_matches_sim(default_map):
    cfg = FilterConfig(num_particles=8,
                       sensor=SensorModelConfig(lookup_mode="gather"))
    start = (2.05, 2.05, 0.0)
    _, enc, _, poses = _episode(default_map, cfg, ticks=120, start=start)
    pred = calibrate.integrate_odometry(enc, start, cfg.motion)
    # Noise-free encoders + same kinematics: dead reckoning is exact.
    err = np.hypot(*(np.asarray(pred[:, :2] - poses[:, :2]).T))
    assert err.max() < 1e-3, err.max()


def test_fit_motion_params_recovers_truth(default_map):
    cfg = FilterConfig(num_particles=8,
                       sensor=SensorModelConfig(lookup_mode="gather"))
    start = (2.05, 2.05, 0.0)
    _, enc, _, poses = _episode(default_map, cfg, ticks=200, start=start)
    # Start 15% off on both constants.
    out = calibrate.fit_motion_params(
        enc, poses, cfg.motion,
        init=dict(wheel_size=cfg.motion.wheel_size * 1.15,
                  wheel_space=cfg.motion.wheel_space * 0.85),
        steps=500, lr=5e-3, start_poses=start)
    ws = float(out["wheel_size"])
    wsp = float(out["wheel_space"])
    assert abs(ws - cfg.motion.wheel_size) / cfg.motion.wheel_size < 0.02, ws
    assert abs(wsp - cfg.motion.wheel_space) / cfg.motion.wheel_space < 0.05, wsp


@pytest.mark.slow
def test_fit_sensor_sigma_recovers_truth(default_map):
    cfg = FilterConfig(num_particles=8,
                       sensor=SensorModelConfig(lookup_mode="gather"))
    true_sigma = 0.07
    angles = np.deg2rad(np.linspace(-118, 118, 48)).astype(np.float32)
    keys = jax.random.split(jax.random.PRNGKey(4), 40)
    poses = jnp.tile(jnp.array([2.05, 2.05, 0.4]), (40, 1))
    scans = jnp.stack([
        sensor.simulate_scan(default_map, poses[i], angles, cfg.sensor,
                             key=keys[i], noise_sigma=true_sigma).ranges
        for i in range(40)])
    # Fit from a 2x-off initial guess.
    out = calibrate.fit_sensor_sigma(
        default_map, poses, scans, angles, cfg.sensor,
        init_sigma=2.0 * true_sigma, steps=400, lr=5e-2)
    s = float(out["sigma"])
    # Range clipping at 0/max_range truncates the noise, biasing the MLE
    # slightly low — 15% is the honest tolerance at 40x48 beams.
    assert abs(s - true_sigma) / true_sigma < 0.15, s
    assert np.isfinite(float(out["loss"]))
