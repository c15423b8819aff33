"""Diagnostics + kidnapped-robot recovery tests."""
import functools
import os.path as osp

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from montecarlolocalisation.config import FilterConfig, SensorModelConfig
from montecarlolocalisation.maps import from_map_file
from montecarlolocalisation.models import diagnostics, filter as mcl
from montecarlolocalisation.sim import robot

MAP_PATH = osp.join(osp.dirname(__file__), "..", "montecarlolocalisation",
                    "maps", "default_map.txt")


def test_weighted_mean_pose():
    parts = jnp.array([[1.0, 2.0, 0.0], [3.0, 4.0, jnp.pi / 2]])
    w = jnp.array([1.0, 3.0])
    pose = np.asarray(diagnostics.weighted_mean_pose(parts, w))
    assert pose[0] == pytest.approx(2.5)
    assert pose[1] == pytest.approx(3.5)
    # circular mean of [0 (w=.25), pi/2 (w=.75)]
    want = np.arctan2(0.75 * 1.0, 0.25 * 1.0 + 0.75 * 0.0)
    assert pose[2] == pytest.approx(want, abs=1e-5)


def test_pairwise_density_tight_vs_diffuse():
    key = jax.random.PRNGKey(0)
    tight = 0.05 * jax.random.normal(key, (800, 2)) + 2.0
    tight = jnp.concatenate([tight, jnp.zeros((800, 1))], axis=-1)
    diffuse = jnp.concatenate(
        [jax.random.uniform(key, (800, 2), minval=0.0, maxval=4.8),
         jnp.zeros((800, 1))], axis=-1)
    rt = float(diagnostics.pairwise_density_ratio(tight))
    rd = float(diagnostics.pairwise_density_ratio(diffuse))
    assert rt > 0.9
    assert rd < 0.3
    assert rt > rd


def test_max_weight_confidence():
    parts = jnp.concatenate([
        jnp.full((90, 3), 1.0),
        jnp.full((10, 3), 4.0)])
    w = jnp.zeros((100,)).at[95].set(5.0)
    ratio, best = diagnostics.max_weight_confidence(parts, w)
    assert float(best[0]) == 4.0
    assert float(ratio) == pytest.approx(0.1)


def test_bresenham_line_of_sight():
    m = from_map_file(MAP_PATH)
    # Across the open center cell (2,2): clear.
    assert bool(diagnostics.bresenham_path_valid(m, 1.85, 2.05, 2.25, 2.05))
    # Through the outer wall: blocked.
    assert not bool(diagnostics.bresenham_path_valid(m, 0.45, 0.45, -0.2, 0.45))
    # Between cells (1,1) and (1,2): (1,1) has R wall and (1,2) has L wall.
    assert not bool(
        diagnostics.bresenham_path_valid(m, 1.25, 1.25, 2.05, 1.25))


def test_kidnap_recovery():
    """Kidnapped-robot: after teleporting the true pose, the filter must go
    lost (song 1) and eventually re-localize near the new pose region —
    the adaptive-injection machinery of monte_carlo.cpp:487-527."""
    maze = from_map_file(MAP_PATH)
    cfg = FilterConfig(num_particles=600,
                       sensor=SensorModelConfig(ray_mode="fixed"))
    angles = np.deg2rad(np.linspace(-118, 118, 24)).astype(np.float32)
    enc, ranges, poses = robot.generate_wander_episode(
        jax.random.PRNGKey(7), maze, cfg, angles, num_ticks=340,
        start_pose=(2.05, 2.05, 0.0), kidnap_tick=170,
        kidnap_pose=(1.25, 3.65, 1.3))
    tp = np.asarray(poses)
    # The teleport happened.
    jump = np.hypot(tp[170, 0] - tp[169, 0], tp[170, 1] - tp[169, 1])
    assert jump > 1.0
    st = mcl.init_state(jax.random.PRNGKey(1), maze, cfg)
    run = jax.jit(functools.partial(mcl.run_episode, m=maze, cfg=cfg))
    final, outs = run(st, enc, ranges, angles)
    songs = np.asarray(outs.song)
    # Lost is declared after the kidnap (injection machinery engaged).
    assert (songs[170:] == 1).any(), "kidnap never detected as lost"
    inj = np.asarray(outs.n_injected)
    assert inj[170:].sum() > 0, "no particles injected after kidnap"


def test_tracking_survives_sensor_faults_and_unmapped_obstacle():
    """Robustness stressors: 10% beam dropout, 5% uniform outliers, and an
    UNMAPPED disc orbiting the maze center (the scan sees it, the map
    raster does not).  A LOCALIZED filter must keep tracking the true
    pose — the w_rand mixture + summed-beam likelihood absorb faulty
    beams.  (Global localization under these faults is seed-dependent in
    the aliased maze; tracking is the deterministic claim.)"""
    import dataclasses

    maze = from_map_file(MAP_PATH)
    cfg = FilterConfig(num_particles=600,
                       sensor=SensorModelConfig(ray_mode="fixed"))
    angles = np.deg2rad(np.linspace(-118, 118, 24)).astype(np.float32)
    start = (2.05, 2.05, 0.0)
    enc, ranges, poses = robot.generate_wander_episode(
        jax.random.PRNGKey(3), maze, cfg, angles, num_ticks=260,
        start_pose=start, dropout_p=0.1, outlier_p=0.05,
        moving_obstacle=(2.45, 2.45, 0.8, 0.15, 0.05))
    st = mcl.init_state(jax.random.PRNGKey(1), maze, cfg)
    # Localize the cloud at the start pose (tracking scenario).
    k = jax.random.PRNGKey(2)
    noise = 0.05 * jax.random.normal(k, st.particles.shape)
    st = dataclasses.replace(
        st, particles=jnp.asarray(start, jnp.float32) + noise)
    run = jax.jit(functools.partial(mcl.run_episode, m=maze, cfg=cfg))
    final, outs = run(st, enc, ranges, angles)
    # The obstacle's close passes (orbit period ~126 ticks) blind much of
    # the scan and can drop confidence transiently; the claims are (a) the
    # filter is confident for most of the episode, (b) whenever confident
    # it is ACCURATE, and (c) it recovers after each blinding.
    ep = np.asarray(outs.exact_pose)
    tp = np.asarray(poses)
    confident = ep[:, 0] >= 0
    assert confident[20:].mean() > 0.6, confident[20:].mean()
    err = np.hypot(ep[:, 0] - tp[:, 0], ep[:, 1] - tp[:, 1])
    acc = err[confident] < 0.45
    assert acc.mean() > 0.9, acc.mean()
    # Recovery: confident again some time after the first loss.
    lost_at = np.flatnonzero(~confident[20:])
    if lost_at.size:
        t0 = lost_at[0] + 20
        assert confident[t0:].any(), "never recovered after blinding"
