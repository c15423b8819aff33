"""Frontier-driven exploration (sim/frontier.py).

No reference counterpart (the reference explores with the blind wanderer
and its map is hand-written); tests pin the phase loop's mechanics on
tiny budgets: coverage grows monotonically, the explorer plans only over
frontier cells, waypoints route over the optimistic wall graph, and the
jitted phase composes (scan + slam + control + dynamics in one scan).
"""
import os.path as osp

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from montecarlolocalisation.config import (FilterConfig, MappingConfig,
                                               SLAMConfig)
from montecarlolocalisation.maps import from_map_file
from montecarlolocalisation.models import mapping, slam
from montecarlolocalisation.sim import frontier

MAP_PATH = osp.join(osp.dirname(__file__), "..", "montecarlolocalisation",
                    "maps", "default_map.txt")


def _scfg(m, particles=16):
    mc = MappingConfig(height=m.height, width=m.width,
                       resolution=float(m.resolution),
                       origin_x=float(m.origin_x),
                       origin_y=float(m.origin_y))
    return SLAMConfig(num_particles=particles, mapping=mc)


def test_frontier_cells_and_planning():
    seen = np.ones((3, 3, 4), bool)
    assert frontier.frontier_cells(seen) == []
    seen[1, 2, 0] = False
    seen[2, 0, 3] = False
    cells = frontier.frontier_cells(seen)
    assert set(cells) == {(1, 2), (2, 0)}
    walls = np.zeros((3, 3, 4), bool)          # fully open graph
    path = frontier.plan_to_nearest_frontier(walls, seen, (0, 0))
    assert path and path[0] == (0, 0) and tuple(path[-1]) in set(cells)
    # Current cell excluded from targets.
    seen2 = np.ones((3, 3, 4), bool)
    seen2[0, 0, 1] = False
    assert frontier.plan_to_nearest_frontier(walls, seen2, (0, 0)) == []
    # Deterministic nearest when rng=None; random among top-k otherwise.
    rng = np.random.default_rng(0)
    p2 = frontier.plan_to_nearest_frontier(walls, seen, (0, 0), rng)
    assert p2 and tuple(p2[-1]) in set(cells)


def test_explore_phase_runs_and_slam_carries():
    m = from_map_file(MAP_PATH)
    cfg = _scfg(m)
    angles = jnp.asarray(
        np.deg2rad(np.linspace(-118, 118, 12)).astype(np.float32))
    st = frontier.init_explore(jax.random.PRNGKey(0), (1.25, 1.25, 0.0),
                               cfg)
    wps = jnp.asarray([[2.0, 1.2], [2.0, 2.0]], jnp.float32)
    st2, (tp, ep) = jax.jit(lambda s, k: frontier.explore_phase(
        s, k, wps, jnp.int32(2), m, cfg, angles, 40,
        slip_noise=0.02))(st, jax.random.PRNGKey(1))
    assert tp.shape == (40, 3) and ep.shape == (40, 3)
    assert np.isfinite(np.asarray(tp)).all()
    # The robot moved and the SLAM map gained evidence.
    assert float(jnp.abs(st2.slam.logodds).max()) > 1.0
    d = np.hypot(float(st2.robot.x) - 1.25, float(st2.robot.y) - 1.25)
    assert d > 0.1
    # Encoders record COMMANDED arcs (slip fault model).
    assert float(st2.robot.encoder_left) != 0.0


@pytest.mark.slow
def test_run_frontier_slam_grows_coverage():
    m = from_map_file(MAP_PATH)
    cfg = _scfg(m, particles=24)
    angles = np.deg2rad(np.linspace(-118, 118, 16)).astype(np.float32)
    st, info = frontier.run_frontier_slam(
        jax.random.PRNGKey(0), m, cfg, angles, phases=7, phase_ticks=80,
        slip_noise=0.02)
    cov = info["coverage"]
    assert cov[-1] > cov[0] and cov[-1] >= 0.2
    assert len(info["truth"]) == len(info["est"]) > 0
    lo = np.asarray(slam.best_map(st.slam))
    walls, seen = mapping.fit_walls(lo, return_explored=True)
    met = mapping.wall_metrics(walls, np.asarray(m.walls), mask=seen)
    assert met["f1"] > 0.5


def test_explore_policies_and_styles_run():
    """Round-5 explorer knobs compose and gather coverage: hybrid and
    wander policies, novelty-biased turns, and the wall-following style
    (each honestly characterized in BENCH_DETAILS' round-5 exploration
    table — these are smoke/mechanics pins, not quality claims)."""
    m = from_map_file(MAP_PATH)
    cfg = _scfg(m)
    angles = np.deg2rad(np.linspace(-118, 118, 12)).astype(np.float32)
    for policy, kw in (("hybrid", {}),
                       ("wander", dict(novelty_bias=1.0)),
                       ("wallfollow", dict(wander_style="wallfollow"))):
        fst, finfo = frontier.run_frontier_slam(
            11, m, cfg, angles, phases=3, phase_ticks=40,
            slip_noise=0.02, policy=policy, **kw)
        cov = finfo["coverage"]
        assert cov[-1] > 0.05, (policy, cov)
        assert np.isfinite(np.asarray(fst.est)).all()
        # Coverage never decreases (evidence only accumulates).
        assert all(b >= a - 1e-9 for a, b in zip(cov, cov[1:])), (policy,
                                                                 cov)


def test_wallfollow_turns_away_from_followed_wall():
    """The follower's avoidance turn must rotate AWAY from the +theta
    (left) side it follows: forced turn_sign = -1 (heading decreases,
    sim convention dtheta = (dL - dR)/wheel_space)."""
    m = from_map_file(MAP_PATH)
    cfg = _scfg(m, particles=8)
    angles = jnp.asarray(np.deg2rad(np.linspace(-118, 118, 12)),
                         jnp.float32)
    st = frontier.init_explore(jax.random.PRNGKey(0), (1.25, 1.25, 0.0),
                               cfg)
    # Face a wall dead ahead so the avoidance turn starts immediately.
    import dataclasses as dc

    from montecarlolocalisation.sim import robot as R

    st = dc.replace(st, robot=R.make_robot(0.35, 1.25, jnp.pi))
    wps = jnp.zeros((4, 2), jnp.float32)
    st2, _ = frontier._explore_tick(
        st, jax.random.PRNGKey(1), wps, jnp.int32(0), m, cfg, angles,
        0.0, 0.0, 8.0, 5.0, 0.4, 0.25, 0.1, wander_style="wallfollow")
    assert int(st2.turn_left) > 0
    assert float(st2.turn_sign) == -1.0
