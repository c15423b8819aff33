"""map_server (PGM + YAML) import/export tests.

Round-trips the reference maze through the PGM pipeline and checks the
imported map drives the full filter; exercises map_server conversion
semantics (negate, thresholds, trinary, vertical flip) and the wall-tensor
synthesis that powers the planner on imported maps.
"""
import os.path as osp

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from montecarlolocalisation.config import (
    FilterConfig, WALL_BOTTOM, WALL_LEFT, WALL_RIGHT, WALL_TOP,
)
from montecarlolocalisation.maps import (
    from_map_file, from_pgm, from_raster, grid, maze, pgm,
)
from montecarlolocalisation.planning import bfs

MAP_TXT = osp.join(osp.dirname(osp.dirname(osp.abspath(__file__))),
                   "montecarlolocalisation", "maps", "default_map.txt")


# ---------------------------------------------------------------- PGM I/O

def test_pgm_p5_roundtrip(tmp_path):
    img = (np.arange(35, dtype=np.uint8) * 7).reshape(5, 7)
    path = str(tmp_path / "t.pgm")
    pgm.save_pgm(path, img)
    np.testing.assert_array_equal(pgm.load_pgm(path), img)


def test_pgm_p2_and_comments(tmp_path):
    path = str(tmp_path / "t.pgm")
    with open(path, "w") as f:
        f.write("P2\n# a comment\n3 2\n# another\n255\n0 128 255\n10 20 30\n")
    np.testing.assert_array_equal(
        pgm.load_pgm(path), [[0, 128, 255], [10, 20, 30]])


def test_pgm_maxval_rescale(tmp_path):
    path = str(tmp_path / "t.pgm")
    with open(path, "w") as f:
        f.write("P2\n2 1\n100\n0 100\n")
    np.testing.assert_array_equal(pgm.load_pgm(path), [[0, 255]])


def test_yaml_parser_minimal(tmp_path):
    path = str(tmp_path / "m.yaml")
    with open(path, "w") as f:
        f.write("image: maze.pgm   # the raster\nresolution: 0.05\n"
                "origin: [-1.0, 2.5, 0.0]\nnegate: 1\n"
                "occupied_thresh: 0.65\nfree_thresh: 0.196\n")
    doc = pgm.parse_map_yaml(path)
    assert doc["image"] == "maze.pgm"
    assert doc["resolution"] == 0.05
    assert doc["origin"] == [-1.0, 2.5, 0.0]
    assert doc["negate"] == 1


# ------------------------------------------------- map_server conversion

def test_occupancy_trinary_semantics():
    # Default (negate=0): dark = occupied.  254 -> p=0.004 free,
    # 0 -> p=1 occupied, 205 -> p=0.196 unknown (not < 0.196).
    tri = pgm.occupancy_from_image(np.array([[254, 0, 205]], dtype=np.uint8))
    np.testing.assert_array_equal(tri, [[0, 100, -1]])
    # negate=1: bright = occupied (205 -> p=0.804 > 0.65 -> occupied).
    tri_n = pgm.occupancy_from_image(
        np.array([[254, 0, 205]], dtype=np.uint8), negate=True)
    np.testing.assert_array_equal(tri_n, [[100, 0, 100]])


def test_vertical_flip_convention(tmp_path):
    # A single occupied pixel in the TOP image row must land at the HIGH
    # y (high row index) of the imported raster.
    img = np.full((4, 3), 254, dtype=np.uint8)
    img[0, 1] = 0
    pgm.save_pgm(str(tmp_path / "m.pgm"), img)
    with open(tmp_path / "m.yaml", "w") as f:
        f.write("image: m.pgm\nresolution: 0.1\norigin: [0, 0, 0]\n")
    m = from_pgm(str(tmp_path / "m.yaml"), unknown="free")
    occ = np.asarray(m.occ)
    assert occ[3, 1] and occ.sum() == 1


def test_unknown_modes(tmp_path):
    img = np.array([[254, 205, 0]], dtype=np.uint8)
    pgm.save_pgm(str(tmp_path / "m.pgm"), img)
    with open(tmp_path / "m.yaml", "w") as f:
        f.write("image: m.pgm\nresolution: 0.1\n")
    m_occ = from_pgm(str(tmp_path / "m.yaml"))
    m_free = from_pgm(str(tmp_path / "m.yaml"), unknown="free")
    np.testing.assert_array_equal(np.asarray(m_occ.occ), [[0, 1, 1]])
    np.testing.assert_array_equal(np.asarray(m_free.occ), [[0, 0, 1]])


def test_keep_origin(tmp_path):
    img = np.full((9, 9), 254, dtype=np.uint8)
    pgm.save_pgm(str(tmp_path / "m.pgm"), img)
    with open(tmp_path / "m.yaml", "w") as f:
        f.write("image: m.pgm\nresolution: 0.1\norigin: [-2.0, 3.0, 0.0]\n")
    m_local = from_pgm(str(tmp_path / "m.yaml"))
    assert (m_local.origin_x, m_local.origin_y) == (0.0, 0.0)
    m_world = from_pgm(str(tmp_path / "m.yaml"), keep_origin=True)
    assert (m_world.origin_x, m_world.origin_y) == (-2.0, 3.0)
    # The filter-core predicates respect the preserved origin.
    assert bool(grid.is_inside_map(m_world, -1.9, 3.1))
    assert not bool(grid.is_inside_map(m_world, 0.1, 0.1))


# ----------------------------------------------------- wall synthesis

def test_synthesize_walls_open_bands():
    # One cell, TOP wall only: corner pixels must not leak into LEFT/RIGHT.
    occ = np.zeros((9, 9), dtype=bool)
    occ[0, :] = True  # TOP edge (row 0) incl. corners
    t = grid.synthesize_walls(occ, 8)
    assert t.shape == (1, 1, 4)
    assert t[0, 0, WALL_TOP]
    assert not t[0, 0, WALL_LEFT]
    assert not t[0, 0, WALL_RIGHT]
    assert not t[0, 0, WALL_BOTTOM]


def test_synthesize_walls_blob_blocks_cell():
    occ = np.zeros((17, 17), dtype=bool)
    occ[3:6, 3:6] = True  # obstacle blob inside cell (0, 0)
    t = grid.synthesize_walls(occ, 8)
    assert t[0, 0].all()          # blob cell: unreachable
    assert not t[1, 1].any()      # clean cell: open


def test_roundtrip_maze_connectivity(tmp_path):
    """default maze -> PGM export -> import: identical raster AND
    identical cell connectivity (BFS distances from every cell)."""
    src = from_map_file(MAP_TXT)
    pgm.export_map(src, str(tmp_path / "maze.pgm"), str(tmp_path / "maze.yaml"))
    imp = from_pgm(str(tmp_path / "maze.yaml"))
    np.testing.assert_array_equal(np.asarray(src.occ), np.asarray(imp.occ))
    assert imp.n_rows == src.n_rows and imp.n_cols == src.n_cols

    src_walls = np.asarray(src.walls)
    imp_walls = np.asarray(imp.walls)
    for start in [(0, 0), (2, 3), (5, 5)]:
        d_src = _bfs_reach(src_walls, start)
        d_imp = _bfs_reach(imp_walls, start)
        np.testing.assert_array_equal(d_src, d_imp)


def _bfs_reach(walls_t, start):
    """Cell-to-cell BFS distances honoring EITHER side's wall flag."""
    R, C, _ = walls_t.shape
    dist = np.full((R, C), -1, dtype=int)
    dist[start] = 0
    frontier = [start]
    # (dr, dc, wall on source, wall on dest)
    moves = [(-1, 0, WALL_TOP, WALL_BOTTOM), (1, 0, WALL_BOTTOM, WALL_TOP),
             (0, -1, WALL_LEFT, WALL_RIGHT), (0, 1, WALL_RIGHT, WALL_LEFT)]
    while frontier:
        nxt = []
        for (r, c) in frontier:
            for dr, dc, ws, wd in moves:
                rr, cc = r + dr, c + dc
                if not (0 <= rr < R and 0 <= cc < C):
                    continue
                if walls_t[r, c, ws] or walls_t[rr, cc, wd]:
                    continue
                if dist[rr, cc] < 0:
                    dist[rr, cc] = dist[r, c] + 1
                    nxt.append((rr, cc))
        frontier = nxt
    return dist


def test_imported_map_runs_planner(tmp_path):
    src = from_map_file(MAP_TXT)
    pgm.export_map(src, str(tmp_path / "m.pgm"), str(tmp_path / "m.yaml"))
    imp = from_pgm(str(tmp_path / "m.yaml"))
    path = bfs.bfs_path(np.asarray(imp.walls), (1, 1), (4, 4))
    assert path[0] == (1, 1) and path[-1] == (4, 4)
    # Every step moves between adjacent cells.
    for (r0, c0), (r1, c1) in zip(path, path[1:]):
        assert abs(r0 - r1) + abs(c0 - c1) == 1


# --------------------------------------------------- end-to-end filter

def test_imported_map_localizes(tmp_path):
    """Full MCL on the imported raster tracks a pose from a near-truth
    init (the imported map is bit-identical, so the likelihood model and
    every fast path must behave)."""
    src = from_map_file(MAP_TXT)
    pgm.export_map(src, str(tmp_path / "m.pgm"), str(tmp_path / "m.yaml"))
    imp = from_pgm(str(tmp_path / "m.yaml"))

    from montecarlolocalisation.models import filter as mcl
    from montecarlolocalisation.models import sensor

    cfg = FilterConfig(num_particles=512)
    angles = np.deg2rad(np.linspace(-118, 118, 24)).astype(np.float32)
    true_pose = jnp.array([1.25, 1.25, 0.5])
    scan = sensor.simulate_scan(imp, true_pose, angles, cfg.sensor)

    key = jax.random.PRNGKey(0)
    near = true_pose[None, :] + 0.05 * jax.random.normal(key, (512, 3))
    import dataclasses

    state = mcl.init_state(jax.random.PRNGKey(1), imp, cfg)
    state = dataclasses.replace(state, particles=near.astype(jnp.float32))
    for _ in range(5):
        state, out = mcl.mcl_step(state, jnp.float32(0.0), jnp.float32(0.0),
                                  scan, imp, cfg)
    best = np.asarray(out.exact_pose)
    assert np.hypot(best[0] - 1.25, best[1] - 1.25) < 0.3


def test_nongridline_raster_falls_back():
    """An off-lattice raster (wall at a non-multiple-of-8 pixel) must
    still produce working weights through the fallback paths."""
    occ = np.zeros((25, 25), dtype=bool)
    occ[:, 0] = occ[:, -1] = occ[0, :] = occ[-1, :] = True
    occ[12, 5:20] = True  # off-gridline wall
    m = from_raster(occ, resolution=0.1)

    from montecarlolocalisation.models import sensor

    cfg = FilterConfig(num_particles=64)
    angles = np.deg2rad(np.linspace(-90, 90, 8)).astype(np.float32)
    scan = sensor.simulate_scan(m, jnp.array([1.2, 0.6, 1.57]), angles,
                                cfg.sensor)
    parts = jnp.tile(jnp.array([[1.2, 0.6, 1.57]]), (64, 1))
    w = sensor.beam_weights(m, parts, scan, cfg.sensor)
    assert np.all(np.isfinite(np.asarray(w)))
    assert float(jnp.max(w)) > 0.0
