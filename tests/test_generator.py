"""Random maze generator + multi-map sweep tests."""
import jax
import numpy as np
import pytest

from montecarlolocalisation.config import FilterConfig, SensorModelConfig
from montecarlolocalisation.maps import from_walls, generator
from montecarlolocalisation.planning import bfs
from montecarlolocalisation.maps import maze as maze_mod
from montecarlolocalisation.parallel import episodes


def test_generated_maze_valid_and_connected():
    for seed in range(4):
        walls = generator.generate_maze(6, 6, seed=seed)
        t = maze_mod.walls_to_tensor(walls)
        # Wall consistency: shared walls listed by both neighbors.
        for r in range(6):
            for c in range(5):
                assert t[r, c, 0] == t[r, c + 1, 2], (seed, r, c)  # R vs L
        for r in range(5):
            for c in range(6):
                assert t[r, c, 3] == t[r + 1, c, 1], (seed, r, c)  # B vs T
        # Outer boundary fully walled.
        assert t[0, :, 1].all() and t[5, :, 3].all()
        assert t[:, 0, 2].all() and t[:, 5, 0].all()
        # Perfect maze: every cell reachable from (0,0).
        for r in range(6):
            for c in range(6):
                assert bfs.bfs_path(t, (0, 0), (r, c)), (seed, r, c)


def test_extra_openings_reduce_walls():
    w0 = maze_mod.walls_to_tensor(generator.generate_maze(6, 6, seed=1))
    w1 = maze_mod.walls_to_tensor(
        generator.generate_maze(6, 6, seed=1, extra_openings=6))
    assert w1.sum() < w0.sum()


def test_generated_maze_rasterizes():
    m = from_walls(generator.generate_maze(4, 4, seed=2))
    assert m.occ.shape == (33, 33)
    assert np.asarray(m.occ).any()


@pytest.mark.slow
def test_multimap_sweep_runs():
    maps = generator.generate_map_batch(2, rows=4, cols=4, seed=0)
    cfg = FilterConfig(num_particles=128,
                       sensor=SensorModelConfig(ray_mode="fixed"))
    angles = np.deg2rad(np.linspace(-118, 118, 8)).astype(np.float32)
    final, outs, poses = episodes.run_multimap_sweep(
        jax.random.PRNGKey(0), maps, cfg, angles, num_ticks=15,
        episodes_per_map=2, start_pose=(0.45, 0.45, 0.0))
    assert final.particles.shape == (4, 128, 3)
    assert poses.shape == (4, 15, 3)
    assert np.isfinite(np.asarray(final.particles)).all()


def test_generated_rooms_valid_and_connected():
    for seed in range(4):
        walls = generator.generate_rooms(6, 6, seed=seed)
        t = maze_mod.walls_to_tensor(walls)
        # Wall consistency + boundary, same invariants as the maze.
        for r in range(6):
            for c in range(5):
                assert t[r, c, 0] == t[r, c + 1, 2], (seed, r, c)
        for r in range(5):
            for c in range(6):
                assert t[r, c, 3] == t[r + 1, c, 1], (seed, r, c)
        assert t[0, :, 1].all() and t[5, :, 3].all()
        assert t[:, 0, 2].all() and t[:, 5, 0].all()
        # Doors keep everything connected.
        for r in range(6):
            for c in range(6):
                assert bfs.bfs_path(t, (0, 0), (r, c)), (seed, r, c)
        # Open regime: fewer internal walls than a perfect maze.
        maze_t = maze_mod.walls_to_tensor(generator.generate_maze(6, 6, seed))
        assert t.sum() < maze_t.sum()


def test_map_batch_styles():
    maps = generator.generate_map_batch(2, rows=4, cols=4, style="rooms")
    assert maps.occ.shape[0] == 2
    mixed = generator.generate_map_batch(2, rows=4, cols=4, style="mixed")
    assert not np.array_equal(np.asarray(mixed.occ[0]),
                              np.asarray(mixed.occ[1]))
    with pytest.raises(ValueError):
        generator.generate_map_batch(1, style="corridor")
