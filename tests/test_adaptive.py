"""Elastic particle budget (io/server.py adapt= + resample.resize_particles).

No reference counterpart: the reference's particle count is a
compile-time constant (monte_carlo.cpp:84).  Asserts the resize primitive
is a correct systematic redraw and the serving policy shrinks the budget
while confidently tracking and snaps back to full on a lost transition.
"""
import os.path as osp

import jax
import jax.numpy as jnp
import numpy as np

from montecarlolocalisation.config import FilterConfig
from montecarlolocalisation.io.server import MCLServer
from montecarlolocalisation.maps import from_map_file
from montecarlolocalisation.models import resample, sensor
from montecarlolocalisation.sim import robot
import pytest

MAP_PATH = osp.join(osp.dirname(__file__), "..", "montecarlolocalisation",
                    "maps", "default_map.txt")


def test_resize_preserves_weighted_distribution():
    key = jax.random.PRNGKey(0)
    n = 4096
    parts = jnp.stack([jnp.linspace(0.0, 1.0, n),
                       jnp.zeros(n), jnp.zeros(n)], axis=-1)
    # 80% of the mass on the second half.
    w = jnp.where(jnp.arange(n) >= n // 2, 4.0, 1.0)
    for n_new in (512, 4096, 8192):
        out, w_out = resample.resize_particles(key, parts, w, n_new)
        assert out.shape == (n_new, 3)
        np.testing.assert_allclose(np.asarray(w_out),
                                   np.full(n_new, 1.0 / n_new), rtol=1e-6)
        frac_hi = float(jnp.mean((out[:, 0] >= 0.5).astype(jnp.float32)))
        assert abs(frac_hi - 0.8) < 0.02, (n_new, frac_hi)


def test_resize_zero_weights_uniform_fallback():
    key = jax.random.PRNGKey(1)
    parts = jax.random.uniform(key, (256, 3))
    out, _ = resample.resize_particles(key, parts, jnp.zeros(256), 128)
    assert out.shape == (128, 3)
    assert bool(jnp.all(jnp.isfinite(out)))
    # Uniform fallback draws across the whole set, not one particle.
    assert len(np.unique(np.asarray(out[:, 0]))) > 32


@pytest.mark.slow
def test_server_budget_shrinks_then_recovers_on_kidnap():
    m = from_map_file(MAP_PATH)
    cfg = FilterConfig(num_particles=1024)
    angles = np.deg2rad(np.linspace(-118, 118, 16)).astype(np.float32)
    enc, scans, truth = robot.generate_wander_episode(
        jax.random.PRNGKey(0), m, cfg, angles, 120,
        start_pose=(2.05, 2.05, 0.0))
    enc, scans = np.asarray(enc), np.asarray(scans)

    srv = MCLServer(m, cfg, angles, seed=3, adapt=(256, 1024),
                    adapt_patience=10)
    assert srv.num_particles == 1024
    sizes = []
    for t in range(120):
        out = srv.tick(enc[t, 0], enc[t, 1], scans[t])
        sizes.append(out["particles"])
    # Tracking confidently -> the budget shrank at some point (a lost
    # transition later in the episode may legitimately have grown it
    # back — that IS the policy).
    assert min(sizes) < 1024, sizes

    # Kidnap: teleport the sensor stream to a different pose; within a
    # few ticks the hysteresis lost transition must have the budget at
    # n_max for global re-localization.
    far_scan = sensor.simulate_scan(
        m, jnp.array([0.45, 4.45, 2.0], jnp.float32),
        jnp.asarray(angles), cfg.sensor)
    grew = False
    for _ in range(60):
        out = srv.tick(0.0, 0.0, np.asarray(far_scan.ranges))
        if out["particles"] == 1024:
            grew = True
            break
    assert grew, f"budget stayed at {srv.num_particles} after kidnap"


def test_server_adapt_reset_restores_full_budget():
    m = from_map_file(MAP_PATH)
    cfg = FilterConfig(num_particles=512)
    angles = np.deg2rad(np.linspace(-118, 118, 12)).astype(np.float32)
    srv = MCLServer(m, cfg, angles, seed=0, adapt=(64, 512),
                    adapt_patience=5)
    srv._set_particle_count(64)
    assert srv.num_particles == 64
    srv.reset(seed=1)
    assert srv.num_particles == 512
