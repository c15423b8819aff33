"""Closed-loop simulation tests: MCL + controllers + waypoints in one scan."""
import os.path as osp

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from montecarlolocalisation.config import FilterConfig, SensorModelConfig
from montecarlolocalisation.maps import from_map_file, maze as maze_mod
from montecarlolocalisation.planning import bfs
from montecarlolocalisation.sim import closed_loop

MAP_PATH = osp.join(osp.dirname(__file__), "..", "montecarlolocalisation",
                    "maps", "default_map.txt")

CFG = FilterConfig(num_particles=400,
                   sensor=SensorModelConfig(ray_mode="fixed"))
ANGLES = np.deg2rad(np.linspace(-118, 118, 16)).astype(np.float32)


@pytest.fixture(scope="module")
def maze():
    return from_map_file(MAP_PATH)


def test_closed_loop_episode_runs(maze):
    wps = np.array([[2.05, 2.05], [2.05, 2.85]], dtype=np.float32)
    run = jax.jit(lambda k: closed_loop.run_closed_loop(
        k, maze, CFG, wps, num_ticks=60, scan_angles=ANGLES,
        start_pose=(2.05, 2.05, 0.0)))
    final, outs = run(jax.random.PRNGKey(0))
    assert outs.true_pose.shape == (60, 3)
    assert np.isfinite(np.asarray(outs.true_pose)).all()
    assert np.isfinite(np.asarray(outs.wheel_cmd)).all()
    # The robot actually moved.
    tp = np.asarray(outs.true_pose)
    assert np.hypot(tp[-1, 0] - tp[0, 0], tp[-1, 1] - tp[0, 1]) > 0.05 or \
        np.abs(tp[:, 2]).max() > 0.1


def test_closed_loop_vmaps_over_episodes(maze):
    wps = np.array([[2.05, 2.05]], dtype=np.float32)
    keys = jax.random.split(jax.random.PRNGKey(1), 3)
    run = jax.jit(jax.vmap(lambda k: closed_loop.run_closed_loop(
        k, maze, CFG, wps, num_ticks=20, scan_angles=ANGLES)))
    final, outs = run(keys)
    assert outs.true_pose.shape == (3, 20, 3)
    # Episodes differ (independent noise).
    tp = np.asarray(outs.true_pose)
    assert not np.allclose(tp[0], tp[1])


def test_mission_waypoints_from_plan():
    walls = maze_mod.walls_to_tensor(maze_mod.load_map_file(MAP_PATH))
    path = bfs.bfs_path(walls, (0, 0), (2, 2))
    wps = closed_loop.mission_waypoints(path)
    assert wps.shape == (len(path), 2)
    # First waypoint is the start cell center: cell (0,0) -> (0.4, 0.4).
    np.testing.assert_allclose(wps[0], [0.4, 0.4], atol=1e-6)
    np.testing.assert_allclose(wps[-1], [2.0, 2.0], atol=1e-6)
