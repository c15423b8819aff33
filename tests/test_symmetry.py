"""Maze symmetry group: detection, physical validity, alias metrics."""
import os.path as osp

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from montecarlolocalisation.config import FilterConfig, SensorModelConfig
from montecarlolocalisation.maps import from_map_file, maze, symmetry
from montecarlolocalisation.models import sensor

MAP_PATH = osp.join(osp.dirname(__file__), "..", "montecarlolocalisation",
                    "maps", "default_map.txt")
WALLS = maze.walls_to_tensor(maze.load_map_file(MAP_PATH))


@pytest.fixture(scope="module")
def grid():
    return from_map_file(MAP_PATH)


@pytest.fixture(scope="module")
def sym():
    return symmetry.maze_symmetries(WALLS)


def test_identity_always_present(sym):
    assert sym.names[0] == "id"
    np.testing.assert_allclose(sym.M[0], np.eye(2))
    np.testing.assert_allclose(sym.t[0], 0.0)
    assert sym.s[0] == 1.0 and sym.dth[0] == 0.0


def test_group_closure_on_walls(sym):
    # Every detected element must preserve the wall tensor by construction;
    # re-verify via the pose action on cell centers: centers map to centers.
    cell = 0.8
    rows, cols = WALLS.shape[:2]
    centers = np.stack(np.meshgrid(
        np.arange(cols) * cell + 0.4, np.arange(rows) * cell + 0.4),
        axis=-1).reshape(-1, 2)
    poses = np.concatenate([centers, np.zeros((len(centers), 1))], axis=-1)
    aliased = np.asarray(sym.apply(jnp.asarray(poses, jnp.float32)))
    for g in range(sym.size):
        pts = aliased[:, g, :2]
        # Each image point is again a cell center.
        snapped = np.round((pts - 0.4) / cell) * cell + 0.4
        np.testing.assert_allclose(pts, snapped, atol=1e-4)
        assert (pts > 0).all() and (pts < max(rows, cols) * cell).all()


def test_symmetries_are_physical(grid, sym):
    """The real check: a simulated scan at pose p equals the scan at g(p)
    for every detected symmetry (the world truly looks identical)."""
    cfg = SensorModelConfig(ray_mode="dda")
    angles = np.deg2rad(np.linspace(-118, 118, 16)).astype(np.float32)
    poses = jnp.asarray([[1.23, 0.61, 0.37],
                         [2.81, 2.17, -1.9],
                         [4.03, 1.31, 2.4]], jnp.float32)
    aliased = sym.apply(poses)                    # [P, G, 3]
    for p in range(poses.shape[0]):
        ref = sensor.simulate_scan(grid, poses[p], angles, cfg)
        for g in range(1, sym.size):
            got = sensor.simulate_scan(grid, aliased[p, g], angles, cfg)
            np.testing.assert_allclose(
                np.asarray(got.ranges), np.asarray(ref.ranges), atol=0.15,
                err_msg=f"symmetry {sym.names[g]} is not physical")


def test_nonsymmetric_map_keeps_identity_only():
    w = np.array(WALLS).copy()
    # Knock a hole in one outer wall: breaks every nontrivial symmetry
    # candidate that survived for the default maze.
    sym0 = symmetry.maze_symmetries(WALLS)
    if sym0.size == 1:
        pytest.skip("default maze already asymmetric")
    w[0, 0, 1] = 1 - w[0, 0, 1]
    s = symmetry.maze_symmetries(w)
    assert s.names == ("id",)


def test_alias_errors_pick_best_alias(sym):
    if sym.size == 1:
        pytest.skip("default maze asymmetric; alias test vacuous")
    truth = jnp.asarray([1.23, 0.61, 0.37], jnp.float32)
    aliases = np.asarray(sym.apply(truth))
    # A best_pose sitting exactly on alias g must yield ~zero error, alias g.
    for g in range(sym.size):
        ae = symmetry.alias_errors(
            jnp.asarray(aliases[g]), truth, sym)
        assert float(ae["err_xy"]) < 1e-4
        assert float(ae["err_theta"]) < 1e-4
        assert int(ae["alias_idx"]) == g


def test_alias_errors_batched(sym):
    truth = jnp.asarray(np.random.RandomState(0).uniform(
        0.5, 4.0, (5, 3)), jnp.float32)
    best = truth + 0.05
    ae = symmetry.alias_errors(best, truth, sym)
    assert ae["err_xy"].shape == (5,)
    assert (np.asarray(ae["err_xy"]) < 0.12).all()


def _seq_apply(ops, w):
    for op in ops:
        w = symmetry._apply_wall(op, w)
    return w


def test_compose_matches_sequential_application():
    # Regression: _compose's channel permutation was applied in the wrong
    # order, so composite candidates (rot90/rot270/anti_transpose) never
    # matched genuinely symmetric mazes.
    rng = np.random.RandomState(3)
    w = (rng.uniform(size=(6, 6, 4)) < 0.4).astype(np.int8)
    h, v, tr = symmetry._FLIP_H, symmetry._FLIP_V, symmetry._TRANSPOSE
    pairs = [(tr, h), (tr, v), (h, v), (v, tr),
             (symmetry._compose(h, v), tr)]
    for a, b in pairs:
        got = symmetry._apply_wall(symmetry._compose(a, b), w)
        want = _seq_apply([a, b], w)
        np.testing.assert_array_equal(got, want)


def _rot90_symmetrized_walls(n=6, seed=5):
    """OR a random consistent wall tensor with its rot90 orbit."""
    from montecarlolocalisation.maps import generator

    wl = generator.generate_maze(n, n, seed=seed)
    w = np.asarray(maze.walls_to_tensor(wl)).astype(np.int8)
    tr, h = symmetry._TRANSPOSE, symmetry._FLIP_H
    rot90 = symmetry._compose(tr, h)
    acc, cur = w, w
    for _ in range(3):
        cur = symmetry._apply_wall(rot90, cur)
        acc = acc | cur
    return acc


def _tensor_to_wall_lists(w):
    return [[[d for d in range(4) if w[r, c, d]]
             for c in range(w.shape[1])] for r in range(w.shape[0])]


def test_rot90_symmetric_maze_detects_full_rotation_group():
    w = _rot90_symmetrized_walls()
    s = symmetry.maze_symmetries(w)
    for name in ["id", "rot90", "rot180", "rot270"]:
        assert name in s.names, (s.names, name)
    # Pose action must map cell centers to cell centers for every element.
    cell = 0.8
    centers = np.stack(np.meshgrid(
        np.arange(6) * cell + 0.4, np.arange(6) * cell + 0.4),
        axis=-1).reshape(-1, 2)
    poses = np.concatenate([centers, np.zeros((len(centers), 1))], axis=-1)
    aliased = np.asarray(s.apply(jnp.asarray(poses, jnp.float32)))
    for g in range(s.size):
        pts = aliased[:, g, :2]
        snapped = np.round((pts - 0.4) / cell) * cell + 0.4
        np.testing.assert_allclose(pts, snapped, atol=1e-4)


def test_rot90_symmetry_is_physical():
    # Scans at a pose and its rot90 alias must agree on the symmetrized
    # maze.  Agreement is only to ~1-2 raster pixels: wall lines draw on
    # the LOW pixel edge of their gridline (raster.py top/left rule), so an
    # isometry about the cell lattice maps wall centers 0.1 m off their
    # mirrored counterparts -- quantile assertion, not allclose.
    from montecarlolocalisation.maps.grid import from_walls

    w = _rot90_symmetrized_walls()
    s = symmetry.maze_symmetries(w)
    gi = s.names.index("rot90")
    grid = from_walls(_tensor_to_wall_lists(w))
    cfg = SensorModelConfig(ray_mode="dda")
    angles = np.deg2rad(np.linspace(-118, 118, 16)).astype(np.float32)
    poses = jnp.asarray([[1.23, 0.61, 0.37], [2.81, 2.17, -1.9]],
                        jnp.float32)
    aliased = s.apply(poses)
    for p in range(poses.shape[0]):
        ref = sensor.simulate_scan(grid, poses[p], angles, cfg)
        got = sensor.simulate_scan(grid, aliased[p, gi], angles, cfg)
        diff = np.abs(np.asarray(got.ranges) - np.asarray(ref.ranges))
        assert np.quantile(diff, 0.85) < 0.15, diff
        assert diff.max() < 0.4, diff


def _mixture_cloud(sym, truth, dom_g, rng, n=4000):
    """Synthetic cloud: 60% tight on alias dom_g, 35% on the true pose,
    5% stray (far from every alias).  Returns (particles, weights,
    expected stray point)."""
    aliases = np.asarray(sym.apply(jnp.asarray(truth, jnp.float32)))
    # A stray anchor > 0.6 m from every alias: scan a coarse lattice.
    xs = np.linspace(0.2, 4.6, 23)
    pts = np.stack(np.meshgrid(xs, xs), axis=-1).reshape(-1, 2)
    dmin = np.sqrt(((pts[:, None, :] - aliases[None, :, :2]) ** 2
                    ).sum(-1)).min(1)
    stray_pt = pts[np.argmax(dmin)]
    assert dmin.max() > 0.6
    n_dom, n_true = int(0.6 * n), int(0.35 * n)
    n_stray = n - n_dom - n_true
    blob = lambda c, k, s: np.concatenate(
        [c[None, :2] + rng.normal(0, s, (k, 2)),
         np.full((k, 1), c[2] if len(c) > 2 else 0.0)], axis=-1)
    parts = np.concatenate([
        blob(aliases[dom_g], n_dom, 0.03),
        blob(aliases[0], n_true, 0.03),
        blob(np.append(stray_pt, 0.0), n_stray, 0.01),
    ]).astype(np.float32)
    return jnp.asarray(parts), jnp.full((n,), 1.0 / n, jnp.float32)


def test_mixture_tracking_masses_and_rmse():
    s = symmetry.maze_symmetries(_rot90_symmetrized_walls())
    assert s.size >= 4
    truth = np.array([1.2, 0.6, 0.4], np.float32)
    dom_g = s.names.index("rot180")
    rng = np.random.RandomState(3)
    parts, w = _mixture_cloud(s, truth, dom_g, rng)
    mt = symmetry.mixture_tracking(parts, w, jnp.asarray(truth), s)
    assert int(mt["dominant_mode"]) == dom_g
    np.testing.assert_allclose(float(mt["dominant_mass"]), 0.60, atol=0.02)
    np.testing.assert_allclose(float(mt["mode_mass"][0]), 0.35, atol=0.02)
    np.testing.assert_allclose(float(mt["stray_mass"]), 0.05, atol=0.01)
    # Tight blob: weighted RMS radius ~ sigma * sqrt(2) = 0.042.
    assert 0.02 < float(mt["tracking_rmse_xy"]) < 0.08
    # Modes with no mass report nan, populated modes finite.
    mm = np.asarray(mt["mode_mass"])
    mr = np.asarray(mt["mode_rmse_xy"])
    assert np.isfinite(mr[dom_g]) and np.isfinite(mr[0])
    assert np.all(np.isnan(mr[mm < 1e-9]))


def test_mixture_tracking_batched_and_weighted():
    s = symmetry.maze_symmetries(_rot90_symmetrized_walls())
    truth = np.array([1.2, 0.6, 0.4], np.float32)
    rng = np.random.RandomState(7)
    p1, w1 = _mixture_cloud(s, truth, s.names.index("rot90"), rng, n=1000)
    p2, w2 = _mixture_cloud(s, truth, 0, rng, n=1000)
    parts = jnp.stack([p1, p2])
    w = jnp.stack([w1, w2])
    tr = jnp.broadcast_to(jnp.asarray(truth), (2, 3))
    mt = symmetry.mixture_tracking(parts, w, tr, s)
    assert mt["mode_mass"].shape == (2, s.size)
    assert int(mt["dominant_mode"][0]) == s.names.index("rot90")
    assert int(mt["dominant_mode"][1]) == 0
    # Weights need not be normalized: scaling them must change nothing.
    mt2 = symmetry.mixture_tracking(parts, w * 37.0, tr, s)
    np.testing.assert_allclose(np.asarray(mt2["dominant_mass"]),
                               np.asarray(mt["dominant_mass"]), atol=1e-5)
